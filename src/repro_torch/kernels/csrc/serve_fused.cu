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
// round-trips through device memory between steps.  The classify reads only
// the S selected columns of the C centroid rows it needs, straight from
// device memory (the whole-tile VMEM residency of the TPU kernel has no
// counterpart worth copying: a per-device bank at the paper's widths is
// ~1.6 MB).  The wrapper clones the carry and this kernel updates the clone
// in place.  Build with -fmad=false: every product and sum is its own
// rounding, as in the plain PyTorch step core.
#include <cuda_runtime.h>
#include <math.h>

#include "l1_topk2.cuh"

#define QMAX 8
#define KMAX 8
#define NEG_SCORE (-1e30f)

// Keep the field order in sync with repro_torch/kernels/fleet_step.py
// (_ServeArgs); serve_args_size() lets the wrapper check the layout.
struct ServeArgs {
  // config, (D, ...)
  const int* policy;
  const unsigned char* imprecise;
  const unsigned char* is_edfm;
  const float* eta;
  const float* alpha;
  const float* beta;
  const unsigned char* persistent;
  const float* capacity;
  const float* e_man;
  const float* e_opt;
  const float* power_on;
  const float* clock_drift;
  const unsigned char* use_exit_thr;
  const float* exit_thr;      // (D, K, U)
  const float* period;        // (D, K)
  const float* rel_deadline;  // (D, K)
  const float* fragments;     // (D, K)
  const int* n_units;         // (D, K)
  const int* n_releases;      // (D, K)
  const float* unit_time;     // (D, K, U)
  const float* unit_energy;   // (D, K, U)
  const float* events;        // (D, NE)
  // device carry, updated in place
  float* energy;
  unsigned char* was_off;
  int* next_rel;              // (D, K)
  int* rr_cursor;
  int* lock_slot;
  int* lock_job;
  unsigned char* q_active;    // (D, Q) ...
  float* q_release;
  float* q_deadline;
  int* q_task;
  int* q_job;
  int* q_unit;
  float* q_time_left;
  int* q_exited;
  int* q_last_pred;
  float* q_mand_time;
  float* q_margin;
  unsigned char* q_correct;
  unsigned char* q_apass;
  int* m_scheduled;           // (D, K) ...
  int* m_correct;
  int* m_misses;
  int* m_units;
  int* m_optional;
  int* m_reboots;
  float* m_busy;
  float* m_idle;
  float* m_wasted;
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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int floor_mod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

// policy.policy_scores for one slot (arithmetic mirrored term by term).
__device__ float policy_score(int policy, bool persistent, float laxity,
                              float release, float utility, bool mandatory,
                              float alpha, float beta, float eta,
                              float energy, float e_opt, float task_rank) {
  float gamma = mandatory ? 1.f : 0.f;
  float base = (1.f - alpha * laxity) + (1.f - beta * utility);
  float zyg;
  if (persistent) {
    zyg = base + gamma;
  } else {
    float gate = (eta * energy >= e_opt) ? 1.f : 0.f;
    zyg = gate * (base + gamma) + (1.f - gate) * gamma * base;
  }
  float edf = -(laxity + 1e-9f * release);
  float edfm = gamma * edf + (1.f - gamma) * NEG_SCORE;
  float rr = -(task_rank * 1e4f + release);
  if (policy == 0) return zyg;
  if (policy == 1) return edf;
  if (policy == 2) return edfm;
  return rr;
}

__global__ void serve_fused_kernel(const ServeArgs a) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= a.D) return;
  const int K = a.K, U = a.U, Q = a.Q, W = a.W;
  const float dt = a.dt;

  // ---- per-device configuration -----------------------------------------
  const int policy = a.policy[d];
  const bool imprecise = a.imprecise[d];
  const bool is_edfm = a.is_edfm[d];
  const float eta = a.eta[d], alpha = a.alpha[d], beta = a.beta[d];
  const bool persistent = a.persistent[d];
  const float capacity = a.capacity[d], e_man = a.e_man[d];
  const float e_opt = a.e_opt[d], power_on = a.power_on[d];
  const float clock_drift = a.clock_drift[d];
  const bool use_exit_thr = a.use_exit_thr[d];
  const float* exit_thr = a.exit_thr + (long)d * K * U;
  const float* period = a.period + (long)d * K;
  const float* rel_deadline = a.rel_deadline + (long)d * K;
  const float* fragments = a.fragments + (long)d * K;
  const int* n_units = a.n_units + (long)d * K;
  const int* n_releases = a.n_releases + (long)d * K;
  const float* unit_time = a.unit_time + (long)d * K * U;
  const float* unit_energy = a.unit_energy + (long)d * K * U;
  const float* events = a.events + (long)d * a.NE;
  const float* cents =
      a.centroids + (a.shared_bank ? 0L : (long)d * K * U * a.C * a.F);
  const float* feats =
      a.sel_feats + (a.per_dev_tables ? (long)d * K * W * U * a.S : 0L);
  const int* labels = a.labels + (a.per_dev_tables ? (long)d * K * W : 0L);
  const long log0 = (long)d * K * W;

  // ---- carry into registers / local arrays -----------------------------
  float energy = a.energy[d];
  bool was_off = a.was_off[d];
  int rr_cursor = a.rr_cursor[d], lock_slot = a.lock_slot[d];
  int lock_job = a.lock_job[d];
  int m_reboots = a.m_reboots[d];
  float m_busy = a.m_busy[d], m_idle = a.m_idle[d], m_wasted = a.m_wasted[d];
  int next_rel[KMAX], m_sched[KMAX], m_corr[KMAX], m_miss[KMAX];
  int m_units[KMAX], m_opt[KMAX];
  for (int k = 0; k < K; ++k) {
    long o = (long)d * K + k;
    next_rel[k] = a.next_rel[o];
    m_sched[k] = a.m_scheduled[o];
    m_corr[k] = a.m_correct[o];
    m_miss[k] = a.m_misses[o];
    m_units[k] = a.m_units[o];
    m_opt[k] = a.m_optional[o];
  }
  bool q_active[QMAX], q_correct[QMAX], q_apass[QMAX];
  float q_release[QMAX], q_deadline[QMAX], q_time_left[QMAX];
  float q_mand_time[QMAX], q_margin[QMAX];
  int q_task[QMAX], q_job[QMAX], q_unit[QMAX], q_exited[QMAX];
  int q_last_pred[QMAX];
  for (int q = 0; q < Q; ++q) {
    long o = (long)d * Q + q;
    q_active[q] = a.q_active[o];
    q_release[q] = a.q_release[o];
    q_deadline[q] = a.q_deadline[o];
    q_task[q] = a.q_task[o];
    q_job[q] = a.q_job[o];
    q_unit[q] = a.q_unit[o];
    q_time_left[q] = a.q_time_left[o];
    q_exited[q] = a.q_exited[o];
    q_last_pred[q] = a.q_last_pred[o];
    q_mand_time[q] = a.q_mand_time[o];
    q_margin[q] = a.q_margin[o];
    q_correct[q] = a.q_correct[o];
    q_apass[q] = a.q_apass[o];
  }

  // step.finish_counts (live) for one retiring slot
  auto finish_slot = [&](int q) {
    bool sched = q_mand_time[q] >= 0.f && q_mand_time[q] <= q_deadline[q];
    bool corr = sched && q_last_pred[q] >= 0 && q_correct[q];
    int tk = clampi(q_task[q], 0, K - 1);
    m_sched[tk] += sched;
    m_corr[tk] += corr;
    m_miss[tk] += !sched;
  };

  for (int s = 0; s < a.n_steps; ++s) {
    const float t = (float)(a.i0 + s) * dt;

    // ---- admit: one release per task, in task order --------------------
    for (int k = 0; k < K; ++k) {
      int nr = next_rel[k];
      float rel_time = (float)nr * period[k];
      bool releasing = nr < n_releases[k] && rel_time <= t;
      bool has_free = false, has_evict = false;
      int first_free = 0, victim = 0;
      float vbest = INFINITY;
      for (int q = 0; q < Q; ++q) {
        if (!q_active[q] && !has_free) {
          has_free = true;
          first_free = q;
        }
        bool ev = q_active[q] && q_exited[q] >= 0;
        has_evict |= ev;
        float key = ev ? q_deadline[q] : INFINITY;
        if (key < vbest) {
          vbest = key;
          victim = q;
        }
      }
      bool evict = releasing && !has_free && has_evict;
      if (evict) {
        finish_slot(victim);
        q_active[victim] = false;
      }
      bool insert = releasing && (has_free || has_evict);
      if (releasing) next_rel[k] = nr + 1;
      if (insert) {
        int slot = has_free ? first_free : victim;
        q_active[slot] = true;
        q_release[slot] = rel_time;
        q_deadline[slot] = rel_time + rel_deadline[k];
        q_task[slot] = k;
        q_job[slot] = nr;
        q_unit[slot] = 0;
        q_time_left[slot] = unit_time[k * U];
        q_exited[slot] = -1;
        q_last_pred[slot] = -1;
        q_mand_time[slot] = -1.f;
        q_margin[slot] = 0.f;
        q_correct[slot] = false;
        q_apass[slot] = false;
      } else if (releasing) {
        m_miss[k] += 1;  // queue overflow with nothing evictable
      }
    }

    // ---- drop expired against the drifting clock -------------------------
    const float t_read = t * (1.f + clock_drift);
    for (int q = 0; q < Q; ++q) {
      if (q_active[q] && t_read >= q_deadline[q]) {
        finish_slot(q);
        q_active[q] = false;
      }
    }

    // ---- pick: priority argmax + capacitor update ------------------------
    int ev_slot = (int)(t / a.slot_s);
    ev_slot = clampi(ev_slot, 0, a.NE - 1);
    const float charge = events[ev_slot] * power_on * dt;
    const int ls = clampi(lock_slot, 0, Q - 1);
    const bool locked =
        lock_slot >= 0 && q_active[ls] && q_job[ls] == lock_job;
    const int forced = locked ? ls : -1;
    float gate_e[QMAX], drain[QMAX];
    float best = 0.f;
    int arg = 0;
    for (int q = 0; q < Q; ++q) {
      int tk = clampi(q_task[q], 0, K - 1);
      int u = clampi(q_unit[q], 0, U - 1);
      float ut = unit_time[tk * U + u];
      float ue = unit_energy[tk * U + u];
      gate_e[q] = fmaxf(ue / fragments[tk], e_man);
      drain[q] = ue * (dt / ut);
      float utility = q_last_pred[q] >= 0 ? q_margin[q] : 0.f;
      float rank = (float)floor_mod(tk - rr_cursor, K);
      float score = policy_score(policy, persistent, q_deadline[q] - t,
                                 q_release[q], utility, q_exited[q] < 0,
                                 alpha, beta, eta, energy, e_opt, rank);
      if (!q_active[q]) score = NEG_SCORE;
      if (q == 0 || score > best) {
        best = score;
        arg = q;
      }
    }
    const float threshold = policy == 0 ? 0.f : (float)(0.5 * -1e30);
    const int sel = forced >= 0 ? forced : arg;
    const bool picked = forced >= 0 || best > threshold;
    const bool run = picked && energy >= gate_e[sel];
    const float e_new =
        fminf(energy + charge, capacity) - (run ? 1.f : 0.f) * drain[sel];

    // ---- selected-slot identity, pre-apply -------------------------------
    const int tk_s = clampi(q_task[sel], 0, K - 1);
    const int u_s = clampi(q_unit[sel], 0, U - 1);
    const int job = clampi(q_job[sel] - a.job0[tk_s], 0, W - 1);
    const bool complete = run && (q_time_left[sel] - dt <= a.dt_eps);
    const int exited_pre = q_exited[sel];
    const bool apass_pre = q_apass[sel];
    const float ddl = q_deadline[sel];
    const int nu_sel = n_units[tk_s];
    const bool mandatory_sel = exited_pre < 0;

    // ---- classify the completing unit against the bank --------------------
    float margin = 0.f;
    int pred = 0;
    bool correct = false, pass_bank = false, passed = false;
    if (complete) {
      const int ku = tk_s * U + u_s;
      const float* x = feats + (((long)tk_s * W + job) * U + u_s) * a.S;
      GatheredCentroids cent{cents + (long)ku * a.C * a.F, a.fidx + (long)ku * a.S,
                             a.F};
      float d1, d2;
      int ci;
      l1_top2(x, a.S, a.C, cent, &d1, &d2, &ci);
      margin = l1_margin(d1, d2);
      pred = a.clabels[ku * a.C + ci];
      correct = pred == labels[tk_s * W + job];
      pass_bank = margin > a.thr[ku];
      passed = use_exit_thr ? margin > exit_thr[ku] : pass_bank;
    }

    // ---- apply_step (live) -------------------------------------------------
    const float frag_t = unit_time[tk_s * U + u_s] / fragments[tk_s];
    const bool reboot = run && was_off;
    const float idle_inc = (picked && !run) ? dt : 0.f;
    if (run) q_time_left[sel] = q_time_left[sel] - dt;
    if (complete) {
      const int unit_old = q_unit[sel];
      const int next_u = clampi(unit_old + 1, 0, U - 1);
      q_last_pred[sel] = u_s;
      q_unit[sel] = unit_old + 1;
      q_time_left[sel] = unit_time[tk_s * U + next_u];
      q_margin[sel] = margin;
      q_correct[sel] = correct;
      const bool exit_now = imprecise && q_exited[sel] < 0 && passed;
      int exited = exit_now ? u_s : q_exited[sel];
      const bool full_mand = exited < 0 && unit_old + 1 >= nu_sel;
      if (full_mand) exited = nu_sel - 1;
      q_exited[sel] = exited;
      if (exit_now || full_mand) q_mand_time[sel] = t + dt;
      const bool job_done =
          unit_old + 1 >= nu_sel || (is_edfm && exited >= 0);
      if (job_done) {
        finish_slot(sel);
        q_active[sel] = false;
      }
      m_units[tk_s] += 1;
      if (!mandatory_sel) m_opt[tk_s] += 1;
      if (policy == 3) rr_cursor = floor_mod(tk_s + 1, K);
    }
    const bool lock_on = picked && !complete;
    lock_slot = lock_on ? sel : -1;
    lock_job = lock_on ? q_job[sel] : -1;
    if (reboot && m_busy > 0.f) m_reboots += 1;
    m_busy = m_busy + (run ? dt : 0.f);
    m_idle = m_idle + idle_inc;
    m_wasted = m_wasted + (reboot ? 0.5f * frag_t : 0.f);
    energy = e_new;
    was_off = run ? false : (picked ? true : was_off);

    // ---- utility-pass latch and outcome log -------------------------------
    if (complete) {
      const bool first_pass = pass_bank && !apass_pre;
      if (pass_bank) q_apass[sel] = true;
      const bool exit_now = imprecise && exited_pre < 0 && passed;
      const int exited_mid = exit_now ? u_s : exited_pre;
      const bool full_mand = exited_mid < 0 && u_s + 1 >= nu_sel;
      const long o = log0 + (long)tk_s * W + job;
      a.log_units[o] = u_s + 1;
      a.log_pred[o] = pred;
      a.log_correct[o] = correct;
      a.log_margin[o] = margin;
      if (first_pass) a.log_exit_unit[o] = u_s;
      if (exit_now || full_mand) a.log_sched[o] = (t + dt) <= ddl;
    }
  }

  // ---- carry back --------------------------------------------------------
  a.energy[d] = energy;
  a.was_off[d] = was_off;
  a.rr_cursor[d] = rr_cursor;
  a.lock_slot[d] = lock_slot;
  a.lock_job[d] = lock_job;
  a.m_reboots[d] = m_reboots;
  a.m_busy[d] = m_busy;
  a.m_idle[d] = m_idle;
  a.m_wasted[d] = m_wasted;
  for (int k = 0; k < K; ++k) {
    long o = (long)d * K + k;
    a.next_rel[o] = next_rel[k];
    a.m_scheduled[o] = m_sched[k];
    a.m_correct[o] = m_corr[k];
    a.m_misses[o] = m_miss[k];
    a.m_units[o] = m_units[k];
    a.m_optional[o] = m_opt[k];
  }
  for (int q = 0; q < Q; ++q) {
    long o = (long)d * Q + q;
    a.q_active[o] = q_active[q];
    a.q_release[o] = q_release[q];
    a.q_deadline[o] = q_deadline[q];
    a.q_task[o] = q_task[q];
    a.q_job[o] = q_job[q];
    a.q_unit[o] = q_unit[q];
    a.q_time_left[o] = q_time_left[q];
    a.q_exited[o] = q_exited[q];
    a.q_last_pred[o] = q_last_pred[q];
    a.q_mand_time[o] = q_mand_time[q];
    a.q_margin[o] = q_margin[q];
    a.q_correct[o] = q_correct[q];
    a.q_apass[o] = q_apass[q];
  }
}

extern "C" int serve_args_size() { return (int)sizeof(ServeArgs); }

extern "C" int serve_fused_launch(const ServeArgs* args, int threads,
                                  void* stream) {
  ServeArgs a = *args;
  int blocks = (a.D + threads - 1) / threads;
  serve_fused_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
