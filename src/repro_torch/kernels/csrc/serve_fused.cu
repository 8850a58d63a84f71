// serve_fused_steps: n_steps live-serving timesteps of every device in ONE
// launch — admit -> drop-expired -> pick -> classify the completing unit
// against the device's centroid bank -> apply -> latch the utility pass ->
// write the per-job outcome log, per step (serve/fleet_engine.serve_step).
//
// Replaces the Pallas TPU kernel repro/kernels/fleet_step.py:
// serve_fused_steps (adapt=False only, like the reference).
// Bound on the H100: latency.  A step is a chain of dependent scalar
// decisions per device, so the work does not vectorise across the queue;
// the bytes a segment must move (the carry and log once each, plus S
// selected features and the C x S selected centroid columns per completed
// unit) are small, and the operation count is a few hundred per device-step.
// Design: one thread per device runs the whole segment's loop with the
// queue (Q <= 8) and task (K <= 8) registers in local arrays, so nothing
// round-trips through device memory between steps.  The step's stages are
// the live (LIVE = true) instances of device_step.cuh, shared with the
// replay kernel fleet_fused.cu.  The classify reads only
// the S selected columns of the C centroid rows it needs, straight from
// device memory (the whole-tile VMEM residency of the TPU kernel has no
// counterpart worth copying: a per-device bank at the paper's widths is
// ~1.6 MB).  The wrapper clones the carry and this kernel updates the clone
// in place.  Build with -fmad=false: every product and sum is its own
// rounding, as in the plain PyTorch step core, except the multiply-adds
// device_step.cuh writes out as __fmaf_rn.
#include "device_step.cuh"
#include "l1_topk2.cuh"

// Keep the field order in sync with repro_torch/kernels/fleet_step.py
// (_ServeArgs); serve_args_size() lets the wrapper check the layout.
struct ServeArgs {
  ConfigPtrs cfg;             // (D, ...)
  CarryPtrs carry;            // updated in place
  // bank and read-only tables
  const float* centroids;     // ([D,] K, U, C, F)
  const float* sel_feats;     // ([D,] K, W, U, S)
  const int* labels;          // ([D,] K, W)
  const int* clabels;         // (K, U, C)
  const int* fidx;            // (K, U, S)
  const float* thr;           // (K, U)
  const int* job0;            // (K,)
  // outcome log, (D, K, W), updated in place
  int* log_units;
  int* log_pred;
  unsigned char* log_correct;
  float* log_margin;
  int* log_exit_unit;
  unsigned char* log_sched;
  // sizes and scalars
  int D, K, U, Q, W, C, F, S, NE;
  int shared_bank, per_dev_tables, i0, n_steps;
  float dt, dt_eps, slot_s;
};

__global__ void serve_fused_kernel(const ServeArgs a) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= a.D) return;
  const int K = a.K, U = a.U, W = a.W;
  const float dt = a.dt;
  const DevConfig g =
      load_config(a.cfg, d, K, U, a.Q, a.NE, dt, a.dt_eps, a.slot_s);
  const float* cents =
      a.centroids + (a.shared_bank ? 0L : (long)d * K * U * a.C * a.F);
  const float* feats =
      a.sel_feats + (a.per_dev_tables ? (long)d * K * W * U * a.S : 0L);
  const int* labels = a.labels + (a.per_dev_tables ? (long)d * K * W : 0L);
  const long log0 = (long)d * K * W;
  DevState s;
  load_state(a.carry, d, K, a.Q, s);

  for (int step = 0; step < a.n_steps; ++step) {
    const float t = (float)(a.i0 + step) * dt;
    const float t_end = t + dt;  // the live clock: two roundings
    admit<true>(s, g, t);
    drop_expired<true>(s, g, t);
    const PickResult pk = pick<true>(s, g, t);

    // ---- selected-slot identity, pre-apply -------------------------------
    const int sel = pk.sel;
    const int tk_s = clampi(s.q_task[sel], 0, K - 1);
    const int u_s = clampi(s.q_unit[sel], 0, U - 1);
    const int job = clampi(s.q_job[sel] - a.job0[tk_s], 0, W - 1);
    const bool completing = pk.run && (s.q_time_left[sel] - dt <= a.dt_eps);
    const int exited_pre = s.q_exited[sel];
    const bool apass_pre = s.q_apass[sel];
    const float ddl = s.q_deadline[sel];
    const int nu_sel = g.n_units[tk_s];

    // ---- classify the completing unit against the bank --------------------
    Outcome out{0.f, false, false};
    int pred = 0;
    bool pass_bank = false;
    if (completing) {
      const int ku = tk_s * U + u_s;
      const float* x = feats + (((long)tk_s * W + job) * U + u_s) * a.S;
      GatheredCentroids cent{cents + (long)ku * a.C * a.F,
                             a.fidx + (long)ku * a.S, a.F};
      float d1, d2;
      int ci;
      l1_top2(x, a.S, a.C, cent, &d1, &d2, &ci);
      out.margin = l1_margin(d1, d2);
      pred = a.clabels[ku * a.C + ci];
      out.correct = pred == labels[tk_s * W + job];
      pass_bank = out.margin > a.thr[ku];
      out.passed = g.use_exit_thr ? out.margin > g.exit_thr[ku] : pass_bank;
    }

    const bool complete = apply_step<true>(s, g, t_end, pk, out);

    // ---- utility-pass latch and outcome log -------------------------------
    if (complete) {
      const bool first_pass = pass_bank && !apass_pre;
      if (pass_bank) s.q_apass[sel] = true;
      const bool exit_now = g.imprecise && exited_pre < 0 && out.passed;
      const int exited_mid = exit_now ? u_s : exited_pre;
      const bool full_mand = exited_mid < 0 && u_s + 1 >= nu_sel;
      const long o = log0 + (long)tk_s * W + job;
      a.log_units[o] = u_s + 1;
      a.log_pred[o] = pred;
      a.log_correct[o] = out.correct;
      a.log_margin[o] = out.margin;
      if (first_pass) a.log_exit_unit[o] = u_s;
      if (exit_now || full_mand) a.log_sched[o] = t_end <= ddl;
    }
  }
  store_state(a.carry, d, K, a.Q, s);
}

extern "C" int serve_args_size() { return (int)sizeof(ServeArgs); }

extern "C" int serve_fused_launch(const ServeArgs* args, int threads,
                                  void* stream) {
  ServeArgs a = *args;
  int blocks = (a.D + threads - 1) / threads;
  serve_fused_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
