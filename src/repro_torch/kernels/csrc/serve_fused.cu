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
// unit) are small, and the operation count is a few hundred per
// device-step.  What a step costs is the length of its dependent chain:
// the scalar stages, and on a completing step the classify's loads and
// adds.
//
// Design: one warp per device.
//   * Lane 0 runs the step's stages, the live (LIVE = true) instances of
//     replay_step.cuh that kernel B (fleet_fused.cu) runs in replay mode:
//     the carry in registers in a ReplayState<QC, KC> (the kernel is
//     instanced on QC in {3, 8} slots and KC in {2, 8} tasks), the device's
//     tables and per-task counters in shared memory, the per-slot gate,
//     drain, utility and correct bit hoisted to admission and unit
//     completion, the harvester event loaded one step ahead.  The clock is
//     the live one of serve_step: t = f32(i0 + step) * dt, t_end = t + dt
//     (two roundings, not B's f32(i0 + step + 1) * dt); the harvester slot
//     comes from t.
//   * A warp holds one device, so it runs that device's path and no union
//     of 32 devices' paths, and the classify of a completing unit is the
//     whole warp's (warp_classify): lane 0 broadcasts with __shfl_sync
//     whether the selected unit completes and its (task, unit) and feature
//     row; the lanes stage the S selected features and the C selected
//     centroid columns (gathered through fidx, SERVE_GB gathers in flight
//     per lane) into shared memory, each window of 32 at a stride of 33
//     floats; each (centroid, window) chain of the reference's window-32
//     order is summed on its own lane (l1_chain), each centroid's window
//     sums fold in order (L1Fold, kernels/l1_topk2.py:window_plan), and the
//     top-2 runs in centroid order (L1Top2) on every lane from shuffled
//     distances, so every lane holds the outcome.  At the serve shape
//     (S = 150, C = 5) that is 5 x 5 = 25 chains, one per lane, each at most
//     32 + 5 adds long, where one thread summed 750 terms before.  The
//     chain, fold and top-2 are l1_topk2.cuh's, which kernel D runs too.
//   * Lane 0 then runs replay_apply<true>, the utility-pass latch and the
//     outcome log.
//
// What the warp layout has to respect:
//   * The shared-memory counters (ReplayTables::count: finish, the admit
//     overflow miss, the unit counts of apply) and the log are written by
//     lane 0 only, and so are the tables and the carry: every stage call
//     sits in a lane-0 branch, so no two lanes race on a +=.
//   * ReplayTables is laid out per warp: entry e of warp w at
//     smem[e * SERVE_WARPS + w].  Each warp's classify stage follows the
//     tables, one contiguous region per warp.
//   * The lanes synchronise with __syncwarp() between staging, summing and
//     folding, and before a chunk overwrites the stage.
//   * A shared bank (bank_mode="shared") has no leading D axis; per-device
//     request streams (5-D sel_feats) and their labels take the device's
//     offset.
//   * No array is indexed at run time (sel_get / unrolled selects, the
//     gather batch unrolled), so ptxas gives no instance a stack frame;
//     chip_smoke.py fails if one reports a stack frame or spills.
// SERVE_WARPS devices per block, by measurement (PERF.md §6).
//
// The kernel reads the caller's carry and writes every element of a new
// one; the outcome log is a clone that the kernel updates in place.  Build
// with -fmad=false: every product and sum is its own rounding, except the
// multiply-adds replay_step.cuh writes out as __fmaf_rn.
#include "l1_topk2.cuh"
#include "replay_step.cuh"

#define SERVE_WARPS 4     // devices (one warp each) per block
#define SERVE_CW 8        // level-0 windows staged per chunk of the classify
#define SERVE_KG 8        // centroids summed per pass over the features
#define SERVE_GB 8        // centroid gathers in flight per lane
#define FULL_MASK 0xffffffffu

// Keep the field order in sync with repro_torch/kernels/fleet_step.py
// (_ServeArgs); serve_args_size() lets the wrapper check the layout.
struct ServeArgs {
  ConfigPtrs cfg;             // (D, ...)
  CarryPtrs carry;            // written: every element of every leaf
  CarryPtrs carry_in;         // read
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
  L1Plan plan;                // window_plan(S)
  float dt, dt_eps, slot_s;
};

// Shared-memory words of one warp's classify stage: the chunk's features
// and C' <= SERVE_KG centroid columns (33 floats per window), the window
// sums, and the chunk's column indices.
__host__ __device__ inline int serve_stage_words(const L1Plan& p, int C) {
  const int nwc = p.n1 < SERVE_CW ? p.n1 : SERVE_CW;
  const int cg = C < SERVE_KG ? C : SERVE_KG;
  return (1 + cg) * L1_SLOT * nwc + cg * L1_SLOT + L1_WIN * nwc;
}

// The L1 top-2 of the feature row x (S floats) against the C centroid rows
// at cent ((C, F), read at the S columns fidx), by the whole warp in the
// reference's order; every lane returns the same result.
__device__ __forceinline__ L1Top2 warp_classify(const float* __restrict__ x,
                                               const float* __restrict__ cent,
                                               const int* __restrict__ fidx,
                                               int S, int C, int F,
                                               const L1Plan& p, float* stage,
                                               int lane) {
  const int XS = L1_SLOT * min(p.n1, SERVE_CW);   // staged floats per row
  const int cg_max = min(C, SERVE_KG);
  float* xs = stage;                              // XS
  float* cs = xs + XS;                            // cg_max x XS
  float* ws = cs + cg_max * XS;                   // cg_max x 33
  int* fs = reinterpret_cast<int*>(ws + cg_max * L1_SLOT);   // the chunk's fidx
  L1Top2 best;
  for (int g0 = 0; g0 < C; g0 += SERVE_KG) {
    const int kg = min(SERVE_KG, C - g0);
    L1Fold fold;                                  // lane < kg: centroid g0 + lane
    for (int wa = 0; wa < p.n1; wa += SERVE_CW) {   // level-0 windows [wa, wb)
      const int wb = min(p.n1, wa + SERVE_CW), nw = wb - wa;
      const int e0 = max(0, wa * L1_WIN - p.lo0);
      const int e1 = min(S, wb * L1_WIN - p.lo0);
      const int span = e1 - e0;
      const int shift = p.lo0 - wa * L1_WIN;      // element e -> position e + shift
      __syncwarp();                               // the last chunk's reads are done
#pragma unroll
      for (int r = 0; r < SERVE_CW; ++r) {        // all of a lane's loads in flight
        const int e = e0 + r * L1_WIN + lane;
        if (e < e1) {
          xs[l1_slot(e, shift)] = x[e];
          fs[e - e0] = fidx[e];
        }
      }
      __syncwarp();
      const int total = kg * span;
      for (int i0 = 0; i0 < total; i0 += L1_WIN * SERVE_GB) {
        float v[SERVE_GB];
        int dst[SERVE_GB];
#pragma unroll
        for (int b = 0; b < SERVE_GB; ++b) {
          const int i = i0 + b * L1_WIN + lane;
          dst[b] = -1;
          v[b] = 0.f;
          if (i < total) {
            const int cl = i / span, e = i - cl * span;
            dst[b] = cl * XS + l1_slot(e0 + e, shift);
            v[b] = cent[(long)(g0 + cl) * F + fs[e]];
          }
        }
#pragma unroll
        for (int b = 0; b < SERVE_GB; ++b)
          if (dst[b] >= 0) cs[dst[b]] = v[b];
      }
      __syncwarp();
      for (int i = lane; i < kg * nw; i += L1_WIN) {   // one chain per lane
        const int cl = i / nw, w = i - cl * nw;
        ws[cl * L1_SLOT + w] = l1_chain(xs + w * L1_SLOT,
                                        cs + cl * XS + w * L1_SLOT, p,
                                        wa + w, S);
      }
      __syncwarp();
      if (lane < kg)
        for (int w = 0; w < nw; ++w)
          fold.add(p, wa + w, ws[lane * L1_SLOT + w]);
    }
    const float dist = lane < kg ? fold.finish(p) : 0.f;
    for (int cl = 0; cl < kg; ++cl)
      best.add(g0 + cl, __shfl_sync(FULL_MASK, dist, cl));
  }
  return best;
}

template <int QC, int KC>
__global__ void __launch_bounds__(32 * SERVE_WARPS)
    serve_fused_kernel(const ServeArgs a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * SERVE_WARPS + warp;
  if (d >= a.D) return;                           // the whole warp
  const bool lead = lane == 0;
  const int K = a.K, U = a.U, W = a.W;
  const float dt = a.dt;
  const ReplayTables tb{smem + warp, SERVE_WARPS, K, U};
  float* stage = smem + SERVE_WARPS * replay_table_words(K, U) +
                 warp * serve_stage_words(a.plan, a.C);
  const ReplayConfig g = replay_config(a.cfg, d, K, U, 0, a.Q, a.NE, dt,
                                       a.dt_eps, a.slot_s);
  const float* cents =
      a.centroids + (a.shared_bank ? 0L : (long)d * K * U * a.C * a.F);
  const float* feats =
      a.sel_feats + (a.per_dev_tables ? (long)d * K * W * U * a.S : 0L);
  const int* labels = a.labels + (a.per_dev_tables ? (long)d * K * W : 0L);
  const long log0 = (long)d * K * W;

  ReplayState<QC, KC> s;                          // lane 0's
  int job0[KC];
  float ev = 0.f;
  if (lead) {
    replay_tables(tb, a.cfg, d, a.cfg.e_man[d], dt);
    replay_load<true>(s, a.carry_in, tb, g, d);
#pragma unroll
    for (int k = 0; k < KC; ++k) job0[k] = k < K ? a.job0[k] : 0;
    ev = g.events[replay_event_slot(g, (float)a.i0 * dt)];
  }
  for (int step = 0; step < a.n_steps; ++step) {
    const float t = (float)(a.i0 + step) * dt;
    const float t_end = t + dt;                   // the live clock: two roundings
    ReplayPick pk{0, false, false, 0.f};
    int ku = -1, frow = 0;   // the completing unit's (task, unit), feature row
    int tk_s = 0, u_s = 0, job = 0, exited_pre = 0, nu_sel = 0, label = 0;
    bool apass_pre = false;
    float ddl = 0.f, thr_bank = 0.f;
    if (lead) {
      const float ev_next =
          g.events[replay_event_slot(g, (float)(a.i0 + step + 1) * dt)];
      replay_admit<true>(s, tb, g, t);
      replay_drop_expired<true>(s, tb, g, t);
      pk = replay_pick<true>(s, g, t, ev * g.power_on);
      ev = ev_next;
      // the selected slot, pre-apply
      const int sel = pk.sel;
      tk_s = clampi(sel_get(s.task, sel), 0, K - 1);
      u_s = clampi(sel_get(s.unit, sel), 0, U - 1);
      job = clampi(sel_get(s.job, sel) - sel_get(job0, tk_s), 0, W - 1);
      exited_pre = sel_get(s.exited, sel);
      apass_pre = bit(s.apass, sel);
      ddl = sel_get(s.deadline, sel);
      nu_sel = tb.n_units(tk_s);
      if (pk.run && sel_get(s.time_left, sel) - dt <= a.dt_eps) {
        ku = tk_s * U + u_s;
        frow = (tk_s * W + job) * U + u_s;
        label = labels[tk_s * W + job];           // in flight during the classify
        thr_bank = a.thr[ku];
      }
    }
    ku = __shfl_sync(FULL_MASK, ku, 0);

    // ---- the whole warp classifies the completing unit ------------------
    Outcome out{0.f, false, false};
    int pred = 0;
    bool pass_bank = false;
    if (ku >= 0) {
      frow = __shfl_sync(FULL_MASK, frow, 0);
      const int* clab = a.clabels + (long)ku * a.C;
      const int my_clab = lane < a.C ? clab[lane] : 0;
      const L1Top2 r =
          warp_classify(feats + (long)frow * a.S, cents + (long)ku * a.C * a.F,
                        a.fidx + (long)ku * a.S, a.S, a.C, a.F, a.plan, stage,
                        lane);
      pred = r.idx < L1_WIN ? __shfl_sync(FULL_MASK, my_clab, r.idx & 31)
                            : clab[r.idx];
      if (lead) {
        out.margin = l1_margin(r.d1, r.d2);
        out.correct = pred == label;
        pass_bank = out.margin > thr_bank;
        out.passed = g.use_exit_thr ? out.margin > tb.thr(tk_s, u_s)
                                    : pass_bank;
      }
    }

    // ---- lane 0: apply, the utility-pass latch and the outcome log -------
    if (lead) {
      const bool complete = replay_apply<true>(s, tb, g, t_end, pk, out);
      if (complete) {
        const bool first_pass = pass_bank && !apass_pre;
        if (pass_bank) s.apass = with_bit(s.apass, pk.sel, true);
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
  }
  if (lead) replay_store(s, a.carry, tb, g, d);
}

extern "C" int serve_args_size() { return (int)sizeof(ServeArgs); }

extern "C" int serve_fused_launch(const ServeArgs* args, void* stream) {
  const ServeArgs a = *args;
  if (a.Q > 8 || a.K > 8) return (int)cudaErrorInvalidValue;
  void (*kernel)(const ServeArgs);
  if (a.Q <= 3)
    kernel = a.K <= 2 ? serve_fused_kernel<3, 2> : serve_fused_kernel<3, 8>;
  else
    kernel = a.K <= 2 ? serve_fused_kernel<8, 2> : serve_fused_kernel<8, 8>;
  // the tables of SERVE_WARPS devices and their classify stages; a size
  // past the card's opt-in limit fails cudaFuncSetAttribute, and the
  // wrapper raises
  const int smem = SERVE_WARPS * 4 *
                   (replay_table_words(a.K, a.U) +
                    serve_stage_words(a.plan, a.C));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (a.D + SERVE_WARPS - 1) / SERVE_WARPS;
  kernel<<<blocks, 32 * SERVE_WARPS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
