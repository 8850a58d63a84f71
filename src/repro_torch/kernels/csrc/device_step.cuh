// The per-device step core for one CUDA thread: the stages of
// repro_torch/core/step.py (admit -> drop-expired -> pick -> apply) on one
// device whose carry sits in registers and local arrays.
//
// Shared by the three kernels that run the step core:
//   fleet_priority.cu  (A) — policy_score + select_and_charge only;
//   fleet_fused.cu     (B) — the whole replay step, LIVE = false;
//   serve_fused.cu     (C) — the whole live step, LIVE = true, plus the
//                            classify and the outcome log around it.
// One copy of each stage keeps B and C from drifting apart, as the
// reference's single device_step does for its two fused kernels.
//
// Numerics: built with -fmad=false, so every product and sum is its own
// rounding, except the four multiply-adds the reference (as XLA compiles it
// on the CPU) forms with one rounding; those are written out as __fmaf_rn:
// 1 - alpha * laxity, 1 - beta * utility, laxity + 1e-9 * release, and the
// capacitor charge energy + power * dt.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define QMAX 8
#define KMAX 8
#define NEG_SCORE (-1e30f)
#define RR_POLICY 3

// The StepParams fields every step kernel reads, (D, ...) in device memory.
// Keep the order in sync with _CFG_FIELDS in repro_torch/kernels/fleet_step.py.
struct ConfigPtrs {
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
};

// The DeviceCarry, (D, ...) in device memory, in DeviceCarry field order.
struct CarryPtrs {
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
};

// One device's configuration: scalars in registers, tables as pointers at
// the device's row.  The replay tables are null in live mode.
struct DevConfig {
  int policy;
  bool imprecise, is_edfm, persistent, use_exit_thr;
  float eta, alpha, beta, capacity, e_man, e_opt, power_on, clock_drift;
  const float* exit_thr;
  const float* period;
  const float* rel_deadline;
  const float* fragments;
  const int* n_units;
  const int* n_releases;
  const float* unit_time;
  const float* unit_energy;
  const float* events;
  const float* margins;           // (K, J, U), replay only
  const unsigned char* passes;
  const unsigned char* correct;
  int K, U, J, Q, NE;
  float dt, dt_eps, slot_s;
};

// One device's carry.
struct DevState {
  float energy, m_busy, m_idle, m_wasted;
  bool was_off;
  int rr_cursor, lock_slot, lock_job, m_reboots;
  int next_rel[KMAX], m_sched[KMAX], m_corr[KMAX], m_miss[KMAX];
  int m_units[KMAX], m_opt[KMAX];
  bool q_active[QMAX], q_correct[QMAX], q_apass[QMAX];
  float q_release[QMAX], q_deadline[QMAX], q_time_left[QMAX];
  float q_mand_time[QMAX], q_margin[QMAX];
  int q_task[QMAX], q_job[QMAX], q_unit[QMAX], q_exited[QMAX];
  int q_last_pred[QMAX];
};

struct PickResult {
  int sel;
  bool picked, run;
  float e_new;
};

// The classify outcome of the selected slot's completing unit (live mode).
struct Outcome {
  float margin;
  bool passed, correct;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int floor_mod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

__device__ inline DevConfig load_config(const ConfigPtrs& c, int d, int K,
                                        int U, int Q, int NE, float dt,
                                        float dt_eps, float slot_s) {
  DevConfig g;
  g.policy = c.policy[d];
  g.imprecise = c.imprecise[d];
  g.is_edfm = c.is_edfm[d];
  g.persistent = c.persistent[d];
  g.use_exit_thr = c.use_exit_thr[d];
  g.eta = c.eta[d];
  g.alpha = c.alpha[d];
  g.beta = c.beta[d];
  g.capacity = c.capacity[d];
  g.e_man = c.e_man[d];
  g.e_opt = c.e_opt[d];
  g.power_on = c.power_on[d];
  g.clock_drift = c.clock_drift[d];
  g.exit_thr = c.exit_thr + (long)d * K * U;
  g.period = c.period + (long)d * K;
  g.rel_deadline = c.rel_deadline + (long)d * K;
  g.fragments = c.fragments + (long)d * K;
  g.n_units = c.n_units + (long)d * K;
  g.n_releases = c.n_releases + (long)d * K;
  g.unit_time = c.unit_time + (long)d * K * U;
  g.unit_energy = c.unit_energy + (long)d * K * U;
  g.events = c.events + (long)d * NE;
  g.margins = nullptr;
  g.passes = nullptr;
  g.correct = nullptr;
  g.K = K;
  g.U = U;
  g.J = 0;
  g.Q = Q;
  g.NE = NE;
  g.dt = dt;
  g.dt_eps = dt_eps;
  g.slot_s = slot_s;
  return g;
}

__device__ inline void load_state(const CarryPtrs& c, int d, int K, int Q,
                                  DevState& s) {
  s.energy = c.energy[d];
  s.was_off = c.was_off[d];
  s.rr_cursor = c.rr_cursor[d];
  s.lock_slot = c.lock_slot[d];
  s.lock_job = c.lock_job[d];
  s.m_reboots = c.m_reboots[d];
  s.m_busy = c.m_busy[d];
  s.m_idle = c.m_idle[d];
  s.m_wasted = c.m_wasted[d];
  for (int k = 0; k < K; ++k) {
    long o = (long)d * K + k;
    s.next_rel[k] = c.next_rel[o];
    s.m_sched[k] = c.m_scheduled[o];
    s.m_corr[k] = c.m_correct[o];
    s.m_miss[k] = c.m_misses[o];
    s.m_units[k] = c.m_units[o];
    s.m_opt[k] = c.m_optional[o];
  }
  for (int q = 0; q < Q; ++q) {
    long o = (long)d * Q + q;
    s.q_active[q] = c.q_active[o];
    s.q_release[q] = c.q_release[o];
    s.q_deadline[q] = c.q_deadline[o];
    s.q_task[q] = c.q_task[o];
    s.q_job[q] = c.q_job[o];
    s.q_unit[q] = c.q_unit[o];
    s.q_time_left[q] = c.q_time_left[o];
    s.q_exited[q] = c.q_exited[o];
    s.q_last_pred[q] = c.q_last_pred[o];
    s.q_mand_time[q] = c.q_mand_time[o];
    s.q_margin[q] = c.q_margin[o];
    s.q_correct[q] = c.q_correct[o];
    s.q_apass[q] = c.q_apass[o];
  }
}

__device__ inline void store_state(const CarryPtrs& c, int d, int K, int Q,
                                   const DevState& s) {
  c.energy[d] = s.energy;
  c.was_off[d] = s.was_off;
  c.rr_cursor[d] = s.rr_cursor;
  c.lock_slot[d] = s.lock_slot;
  c.lock_job[d] = s.lock_job;
  c.m_reboots[d] = s.m_reboots;
  c.m_busy[d] = s.m_busy;
  c.m_idle[d] = s.m_idle;
  c.m_wasted[d] = s.m_wasted;
  for (int k = 0; k < K; ++k) {
    long o = (long)d * K + k;
    c.next_rel[o] = s.next_rel[k];
    c.m_scheduled[o] = s.m_sched[k];
    c.m_correct[o] = s.m_corr[k];
    c.m_misses[o] = s.m_miss[k];
    c.m_units[o] = s.m_units[k];
    c.m_optional[o] = s.m_opt[k];
  }
  for (int q = 0; q < Q; ++q) {
    long o = (long)d * Q + q;
    c.q_active[o] = s.q_active[q];
    c.q_release[o] = s.q_release[q];
    c.q_deadline[o] = s.q_deadline[q];
    c.q_task[o] = s.q_task[q];
    c.q_job[o] = s.q_job[q];
    c.q_unit[o] = s.q_unit[q];
    c.q_time_left[o] = s.q_time_left[q];
    c.q_exited[o] = s.q_exited[q];
    c.q_last_pred[o] = s.q_last_pred[q];
    c.q_mand_time[o] = s.q_mand_time[q];
    c.q_margin[o] = s.q_margin[q];
    c.q_correct[o] = s.q_correct[q];
    c.q_apass[o] = s.q_apass[q];
  }
}

// policy.policy_scores for one active slot (term by term, the same
// roundings as the plain version).
__device__ inline float policy_score(int policy, bool persistent,
                                     float laxity, float release,
                                     float utility, bool mandatory,
                                     float alpha, float beta, float eta,
                                     float energy, float e_opt,
                                     float task_rank) {
  float gamma = mandatory ? 1.f : 0.f;
  float base = __fmaf_rn(-alpha, laxity, 1.f) + __fmaf_rn(-beta, utility, 1.f);
  float zyg;
  if (persistent) {
    zyg = base + gamma;
  } else {
    float gate = (eta * energy >= e_opt) ? 1.f : 0.f;
    zyg = gate * (base + gamma) + (1.f - gate) * gamma * base;
  }
  float edf = -__fmaf_rn(1e-9f, release, laxity);
  float edfm = gamma * edf + (1.f - gamma) * NEG_SCORE;
  float rr = -(task_rank * 1e4f + release);
  if (policy == 0) return zyg;
  if (policy == 1) return edf;
  if (policy == 2) return edfm;
  return rr;
}

// step.select_and_charge: first-index argmax, forced slot, threshold,
// energy gate and the capacitor update.
__device__ inline PickResult select_and_charge(
    const float* scores, int Q, float threshold, int forced, float energy,
    float power, float capacity, const float* gate_e, const float* drain,
    float dt) {
  float best = scores[0];
  int arg = 0;
  for (int q = 1; q < Q; ++q) {
    if (scores[q] > best) {
      best = scores[q];
      arg = q;
    }
  }
  PickResult p;
  p.sel = forced >= 0 ? forced : arg;
  p.picked = forced >= 0 || best > threshold;
  p.run = p.picked && energy >= gate_e[p.sel];
  p.e_new = fminf(__fmaf_rn(power, dt, energy), capacity) -
            (p.run ? 1.f : 0.f) * drain[p.sel];
  return p;
}

__device__ __forceinline__ float policy_threshold(int policy) {
  return policy == 0 ? 0.f : (float)(0.5 * -1e30);
}

// step.finish_counts for one retiring slot.
template <bool LIVE>
__device__ inline void finish_slot(DevState& s, const DevConfig& g, int q) {
  const bool sched =
      s.q_mand_time[q] >= 0.f && s.q_mand_time[q] <= s.q_deadline[q];
  const int tk = clampi(s.q_task[q], 0, g.K - 1);
  bool corr;
  if (LIVE) {
    corr = sched && s.q_last_pred[q] >= 0 && s.q_correct[q];
  } else {
    const int job = clampi(s.q_job[q], 0, g.J - 1);
    const int lp = clampi(s.q_last_pred[q], 0, g.U - 1);
    corr = sched && s.q_last_pred[q] >= 0 &&
           g.correct[((long)tk * g.J + job) * g.U + lp];
  }
  s.m_sched[tk] += sched;
  s.m_corr[tk] += corr;
  s.m_miss[tk] += !sched;
}

// step.admit: at most one release per task, in task order; on a full
// queue evict the earliest-deadline job whose mandatory part is done.
template <bool LIVE>
__device__ inline void admit(DevState& s, const DevConfig& g, float t) {
  for (int k = 0; k < g.K; ++k) {
    const int nr = s.next_rel[k];
    const float rel_time = (float)nr * g.period[k];
    const bool releasing = nr < g.n_releases[k] && rel_time <= t;
    bool has_free = false, has_evict = false;
    int first_free = 0, victim = 0;
    float vbest = INFINITY;
    for (int q = 0; q < g.Q; ++q) {
      if (!s.q_active[q] && !has_free) {
        has_free = true;
        first_free = q;
      }
      const bool ev = s.q_active[q] && s.q_exited[q] >= 0;
      has_evict |= ev;
      const float key = ev ? s.q_deadline[q] : INFINITY;
      if (key < vbest) {
        vbest = key;
        victim = q;
      }
    }
    const bool evict = releasing && !has_free && has_evict;
    if (evict) {
      finish_slot<LIVE>(s, g, victim);
      s.q_active[victim] = false;
    }
    const bool insert = releasing && (has_free || has_evict);
    if (releasing) s.next_rel[k] = nr + 1;
    if (insert) {
      const int slot = has_free ? first_free : victim;
      s.q_active[slot] = true;
      s.q_release[slot] = rel_time;
      s.q_deadline[slot] = rel_time + g.rel_deadline[k];
      s.q_task[slot] = k;
      s.q_job[slot] = nr;
      s.q_unit[slot] = 0;
      s.q_time_left[slot] = g.unit_time[k * g.U];
      s.q_exited[slot] = -1;
      s.q_last_pred[slot] = -1;
      s.q_mand_time[slot] = -1.f;
      s.q_margin[slot] = 0.f;
      s.q_correct[slot] = false;
      s.q_apass[slot] = false;
    } else if (releasing) {
      s.m_miss[k] += 1;  // queue overflow with nothing evictable
    }
  }
}

// step.drop_expired against the device's drifting clock.
template <bool LIVE>
__device__ inline void drop_expired(DevState& s, const DevConfig& g,
                                    float t) {
  const float t_read = t * (1.f + g.clock_drift);
  for (int q = 0; q < g.Q; ++q) {
    if (s.q_active[q] && t_read >= s.q_deadline[q]) {
      finish_slot<LIVE>(s, g, q);
      s.q_active[q] = false;
    }
  }
}

// step.pick: pick_inputs, policy_scores and select_and_charge.
template <bool LIVE>
__device__ inline PickResult pick(const DevState& s, const DevConfig& g,
                                  float t) {
  int ev_slot = (int)(t / g.slot_s);
  ev_slot = clampi(ev_slot, 0, g.NE - 1);
  const float power = g.events[ev_slot] * g.power_on;
  const int ls = clampi(s.lock_slot, 0, g.Q - 1);
  const bool locked =
      s.lock_slot >= 0 && s.q_active[ls] && s.q_job[ls] == s.lock_job;
  const int forced = locked ? ls : -1;
  float gate_e[QMAX], drain[QMAX], scores[QMAX];
  for (int q = 0; q < g.Q; ++q) {
    const int tk = clampi(s.q_task[q], 0, g.K - 1);
    const int u = clampi(s.q_unit[q], 0, g.U - 1);
    const float ut = g.unit_time[tk * g.U + u];
    const float ue = g.unit_energy[tk * g.U + u];
    gate_e[q] = fmaxf(ue / g.fragments[tk], g.e_man);
    drain[q] = ue * (g.dt / ut);
    float margin;
    if (LIVE) {
      margin = s.q_margin[q];
    } else {
      const int job = clampi(s.q_job[q], 0, g.J - 1);
      const int lp = clampi(s.q_last_pred[q], 0, g.U - 1);
      margin = g.margins[((long)tk * g.J + job) * g.U + lp];
    }
    const float utility = s.q_last_pred[q] >= 0 ? margin : 0.f;
    const float rank = (float)floor_mod(tk - s.rr_cursor, g.K);
    const float score = policy_score(
        g.policy, g.persistent, s.q_deadline[q] - t, s.q_release[q], utility,
        s.q_exited[q] < 0, g.alpha, g.beta, g.eta, s.energy, g.e_opt, rank);
    scores[q] = s.q_active[q] ? score : NEG_SCORE;
  }
  return select_and_charge(scores, g.Q, policy_threshold(g.policy), forced,
                           s.energy, power, g.capacity, gate_e, drain, g.dt);
}

// step.apply_step: advance the selected slot by dt; on a unit boundary
// test the utility (replay tables, or the live outcome), retire finished
// jobs and release the lock.  ``t_end`` stamps the mandatory-completion
// time.  Returns whether the selected unit completed.
template <bool LIVE>
__device__ inline bool apply_step(DevState& s, const DevConfig& g,
                                  float t_end, const PickResult& pk,
                                  const Outcome& out) {
  const int K = g.K, U = g.U;
  const float dt = g.dt;
  const int sel = pk.sel;
  const int tk_s = clampi(s.q_task[sel], 0, K - 1);
  const int u_s = clampi(s.q_unit[sel], 0, U - 1);
  const float frag_t = g.unit_time[tk_s * U + u_s] / g.fragments[tk_s];
  const bool reboot = pk.run && s.was_off;
  const float idle_inc = (pk.picked && !pk.run) ? dt : 0.f;
  bool complete = false;
  if (pk.run) {
    s.q_time_left[sel] = s.q_time_left[sel] - dt;
    complete = s.q_time_left[sel] <= g.dt_eps;
  }
  if (complete) {
    const int unit_old = s.q_unit[sel];
    const int next_u = clampi(unit_old + 1, 0, U - 1);
    const bool mandatory_sel = s.q_exited[sel] < 0;
    const int nu = g.n_units[tk_s];
    s.q_last_pred[sel] = u_s;
    s.q_unit[sel] = unit_old + 1;
    s.q_time_left[sel] = g.unit_time[tk_s * U + next_u];
    bool passed;
    if (LIVE) {
      s.q_margin[sel] = out.margin;
      s.q_correct[sel] = out.correct;
      passed = out.passed;
    } else {
      const int job = clampi(s.q_job[sel], 0, g.J - 1);
      const long kju = ((long)tk_s * g.J + job) * U + u_s;
      passed = g.use_exit_thr ? g.margins[kju] > g.exit_thr[tk_s * U + u_s]
                              : (bool)g.passes[kju];
    }
    const bool exit_now = g.imprecise && s.q_exited[sel] < 0 && passed;
    int exited = exit_now ? u_s : s.q_exited[sel];
    const bool full_mand = exited < 0 && unit_old + 1 >= nu;
    if (full_mand) exited = nu - 1;
    s.q_exited[sel] = exited;
    if (exit_now || full_mand) s.q_mand_time[sel] = t_end;
    const bool job_done = unit_old + 1 >= nu || (g.is_edfm && exited >= 0);
    if (job_done) {
      finish_slot<LIVE>(s, g, sel);
      s.q_active[sel] = false;
    }
    s.m_units[tk_s] += 1;
    if (!mandatory_sel) s.m_opt[tk_s] += 1;
    if (g.policy == RR_POLICY) s.rr_cursor = floor_mod(tk_s + 1, K);
  }
  const bool lock_on = pk.picked && !complete;
  s.lock_job = lock_on ? s.q_job[sel] : -1;
  s.lock_slot = lock_on ? sel : -1;
  if (reboot && s.m_busy > 0.f) s.m_reboots += 1;
  s.m_busy = s.m_busy + (pk.run ? dt : 0.f);
  s.m_idle = s.m_idle + idle_inc;
  s.m_wasted = s.m_wasted + (reboot ? 0.5f * frag_t : 0.f);
  s.energy = pk.e_new;
  s.was_off = pk.run ? false : (pk.picked ? true : s.was_off);
  return complete;
}
