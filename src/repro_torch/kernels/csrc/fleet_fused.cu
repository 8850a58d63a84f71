// fleet_fused_steps: n_steps replay timesteps of every device in ONE launch
// — admit -> drop-expired -> pick -> apply per step, against the replayed
// job profiles (margins / passes / correct tables), as
// repro_torch/core/step.py:device_step does with live = False.
//
// Replaces the Pallas TPU kernel repro/kernels/fleet_step.py:
// fleet_fused_steps.
// Bound on the H100: latency.  A step is a chain of dependent scalar
// decisions per device (admission, expiry, a Q-way argmax, the energy gate,
// the unit boundary), so the work does not vectorise across the queue; the
// bytes a segment must move (the config and carry once each, plus one
// table entry per completed unit) are small, and the operation count is a
// few hundred per device-step.  What a step costs is the length of that
// chain, so the design keeps loads and local memory out of it.
// Design: one thread per device runs the whole segment's loop on the
// stages of replay_step.cuh: the carry in registers (the kernel is
// instanced on caps QC >= Q and KC >= K, every slot and task loop unrolled
// with a predicate, so no array is indexed at run time and there is no
// stack frame), the device's tables in shared memory, the per-slot gate,
// drain, utility and correct bit hoisted to the events that change them,
// and the next step's harvester event loaded one step ahead.  Blocks of
// FLEET_THREADS = 16 devices, by measurement (PERF.md §6; 16 beat 32 and
// 64 at 1,600 and 16,000 devices): a warp runs the union of its devices'
// paths each step, so fewer devices to a warp take fewer of the rare ones;
// 1,600 devices then occupy 100 SMs.  The clock is
// the replay clock t = f32(i0+s) * dt, t_end = f32(i0+s+1) * dt.  The
// kernel reads the caller's carry and writes every element of a new one,
// so the wrapper allocates the output and copies nothing.
// Build with -fmad=false.
#include "replay_step.cuh"

#define FLEET_THREADS 16   // devices per block

// Keep the field order in sync with repro_torch/kernels/fleet_step.py
// (_FleetArgs); fleet_args_size() lets the wrapper check the layout.
struct FleetArgs {
  ConfigPtrs cfg;               // (D, ...)
  const float* margins;         // (D, K, J, U)
  const unsigned char* passes;  // (D, K, J, U)
  const unsigned char* correct; // (D, K, J, U)
  CarryPtrs carry;              // written: every element of every leaf
  CarryPtrs carry_in;           // read
  int D, K, U, J, Q, NE, i0, n_steps;
  float dt, dt_eps, slot_s;
};

template <int QC, int KC>
__global__ void fleet_fused_kernel(const FleetArgs a) {
  extern __shared__ float smem[];
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= a.D) return;
  const ReplayTables tb{smem + threadIdx.x, (int)blockDim.x, a.K, a.U};
  ReplayConfig g = replay_config(a.cfg, d, a.K, a.U, a.J, a.Q, a.NE, a.dt,
                                 a.dt_eps, a.slot_s);
  const long tab = (long)d * a.K * a.J * a.U;
  g.margins = a.margins + tab;
  g.passes = a.passes + tab;
  g.correct = a.correct + tab;
  replay_tables(tb, a.cfg, d, a.cfg.e_man[d], a.dt);
  ReplayState<QC, KC> s;
  replay_load<false>(s, a.carry_in, tb, g, d);
  const Outcome none{0.f, false, false};
  float t = (float)a.i0 * a.dt;
  float ev = g.events[replay_event_slot(g, t)];
  for (int step = 0; step < a.n_steps; ++step) {
    const float t_end = (float)(a.i0 + step + 1) * a.dt;
    const float ev_next = g.events[replay_event_slot(g, t_end)];
    replay_admit<false>(s, tb, g, t);
    replay_drop_expired<false>(s, tb, g, t);
    const ReplayPick pk = replay_pick<false>(s, g, t, ev * g.power_on);
    replay_apply<false>(s, tb, g, t_end, pk, none);
    t = t_end;   // f32(i0 + step + 1) * dt, the next step's clock
    ev = ev_next;
  }
  replay_store(s, a.carry, tb, g, d);
}

extern "C" int fleet_args_size() { return (int)sizeof(FleetArgs); }

extern "C" int fleet_fused_launch(const FleetArgs* args, void* stream) {
  const FleetArgs a = *args;
  if (a.Q > 8 || a.K > 8) return (int)cudaErrorInvalidValue;
  void (*kernel)(const FleetArgs);
  if (a.Q <= 3)
    kernel = a.K <= 2 ? fleet_fused_kernel<3, 2> : fleet_fused_kernel<3, 8>;
  else
    kernel = a.K <= 2 ? fleet_fused_kernel<8, 2> : fleet_fused_kernel<8, 8>;
  // a device's tables in shared memory; a K x U past the card's opt-in
  // limit fails cudaFuncSetAttribute, and the wrapper raises
  const int smem = FLEET_THREADS * replay_table_words(a.K, a.U) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (a.D + FLEET_THREADS - 1) / FLEET_THREADS;
  kernel<<<blocks, FLEET_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
