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
// few hundred per device-step.
// Design: one thread per device runs the whole segment's loop with the
// queue (Q <= 8) and task (K <= 8) registers in local arrays, so nothing
// round-trips through device memory between steps; the stages are the
// replay (LIVE = false) instances of device_step.cuh, shared with the live
// kernel serve_fused.cu.  The clock is the replay clock t = f32(i0+s) * dt,
// t_end = f32(i0+s+1) * dt.  One thread per device leaves most of the card
// idle at the paper's sweep sizes (1,600 devices fill 13 blocks of 128 on
// 132 SMs); a wider layout is later work.  The wrapper clones the carry and
// this kernel updates the clone in place.  Build with -fmad=false.
#include "device_step.cuh"

// Keep the field order in sync with repro_torch/kernels/fleet_step.py
// (_FleetArgs); fleet_args_size() lets the wrapper check the layout.
struct FleetArgs {
  ConfigPtrs cfg;               // (D, ...)
  const float* margins;         // (D, K, J, U)
  const unsigned char* passes;  // (D, K, J, U)
  const unsigned char* correct; // (D, K, J, U)
  CarryPtrs carry;              // updated in place
  int D, K, U, J, Q, NE, i0, n_steps;
  float dt, dt_eps, slot_s;
};

__global__ void fleet_fused_kernel(const FleetArgs a) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= a.D) return;
  DevConfig g = load_config(a.cfg, d, a.K, a.U, a.Q, a.NE, a.dt, a.dt_eps,
                            a.slot_s);
  const long tab = (long)d * a.K * a.J * a.U;
  g.margins = a.margins + tab;
  g.passes = a.passes + tab;
  g.correct = a.correct + tab;
  g.J = a.J;
  DevState s;
  load_state(a.carry, d, a.K, a.Q, s);
  const Outcome none{0.f, false, false};
  for (int step = 0; step < a.n_steps; ++step) {
    const float t = (float)(a.i0 + step) * a.dt;
    const float t_end = (float)(a.i0 + step + 1) * a.dt;
    admit<false>(s, g, t);
    drop_expired<false>(s, g, t);
    const PickResult pk = pick<false>(s, g, t);
    apply_step<false>(s, g, t_end, pk, none);
  }
  store_state(a.carry, d, a.K, a.Q, s);
}

extern "C" int fleet_args_size() { return (int)sizeof(FleetArgs); }

extern "C" int fleet_fused_launch(const FleetArgs* args, int threads,
                                  void* stream) {
  FleetArgs a = *args;
  int blocks = (a.D + threads - 1) / threads;
  fleet_fused_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
