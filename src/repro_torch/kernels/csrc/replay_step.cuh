// The per-device step core with its carry in registers: the stages of
// repro_torch/core/step.py (admit -> drop-expired -> pick -> apply) for one
// device, instanced on compile-time caps QC >= Q queue slots and KC >= K
// tasks.  The one copy of the step's stages on the card:
//   fleet_fused.cu (kernel B) runs them in replay mode (LIVE = false),
//     against the replayed margins / passes / correct tables, one device
//     per thread;
//   serve_fused.cu (kernel C) runs them in live mode (LIVE = true), the
//     outcome of a completing unit from its classify against the device's
//     bank, one device per warp (lane 0 runs the stages).
// Both are held bit for bit against the same plain
// repro_torch/core/step.py:device_step.  The pure helpers (policy_score,
// clampi, floor_mod, policy_threshold, nan_fminf / nan_fmaxf, Outcome, the
// pointer structs) come from device_step.cuh.  Every stage reads and writes
// one device's tables and counters (ReplayTables), so one thread per device
// calls it.
//
// What keeps the step's dependent chain short:
//   * No array is indexed at run time.  Every loop over slots or tasks is
//     unrolled to its cap with a predicate (q < Q, k < K), and a slot
//     chosen at run time (the victim, the selected slot, the lock slot) is
//     read and written by a select over the unrolled slots.  The carry
//     stays in registers; ptxas reports no stack frame.
//   * The device's tables sit in shared memory: unit_time, exit_thr and
//     the per-unit energy gate and drain (K x U), period, rel_deadline,
//     fragments, n_units, n_releases and the per-task counters (K), one
//     column per thread (entry e of thread t at e * T + t: no bank
//     conflicts; a warp per device in C: entry e of warp w at e * W + w).
//     The harvester event of the next step is loaded one step ahead.
//   * Per-slot values are hoisted out of the step: the energy gate
//     fmaxf(ue / fragments, e_man), the drain ue * (dt / ut), the utility
//     (the replay margin at last_pred, 0 before the first unit) and the
//     correct-table bit at last_pred.  Each is a function of (q_task,
//     q_unit, q_job, q_last_pred), which change only when a slot is
//     admitted or completes a unit, so each is computed then, with the
//     same operations on the same fields, and once per slot from the carry
//     at kernel start.  Inactive slots keep theirs: select_and_charge reads
//     the drain of slot 0 when no slot scores, and (run ? 1 : 0) * drain
//     must give the same NaN for a stale slot whose drain is infinite.
//   * A next release time per task, (float)next_rel * period or +inf once
//     the releases run out, so admit tests one compare per task per step.
//   * Few branches.  In B a warp holds many devices, so it runs the union
//     of their paths each step; pick forms all four policies' scores and
//     selects (policy_score), as a branch per policy measured slower, and
//     so did loading a unit's table entries when it starts instead of when
//     it completes (the entries sit in L1; PERF.md §6 has both times).
//   * The capacitor's clamp and the energy gate's floor propagate NaN as
//     torch.minimum / torch.maximum do (nan_fminf, nan_fmaxf of
//     device_step.cuh): a NaN charge (0 x inf above) stays NaN, as in the
//     plain version and the reference, where fminf would have reset it to
//     the capacity.
//
// Numerics as device_step.cuh: built with -fmad=false; the four
// multiply-adds the reference forms with one rounding are the __fmaf_rn of
// policy_score (three) and of the capacitor charge.
#pragma once

#include "device_step.cuh"

// A device's private tables in shared memory: entry e at p[e * T].
struct ReplayTables {
  float* p;   // the block's shared memory, offset by the device's index in
              // the block (its thread in B, its warp in C)
  int T, K, U;

  __device__ __forceinline__ float& f(int e) const { return p[e * T]; }
  __device__ __forceinline__ int& n(int e) const {
    return reinterpret_cast<int*>(p)[e * T];
  }
  __device__ __forceinline__ float& ut(int k, int u) const {
    return f(k * U + u);
  }
  __device__ __forceinline__ float& gate(int k, int u) const {
    return f(K * U + k * U + u);
  }
  __device__ __forceinline__ float& drain(int k, int u) const {
    return f(2 * K * U + k * U + u);
  }
  __device__ __forceinline__ float& thr(int k, int u) const {
    return f(3 * K * U + k * U + u);
  }
  __device__ __forceinline__ float& period(int k) const {
    return f(4 * K * U + k);
  }
  __device__ __forceinline__ float& rel_deadline(int k) const {
    return f(4 * K * U + K + k);
  }
  __device__ __forceinline__ float& fragments(int k) const {
    return f(4 * K * U + 2 * K + k);
  }
  __device__ __forceinline__ int& n_units(int k) const {
    return n(4 * K * U + 3 * K + k);
  }
  __device__ __forceinline__ int& n_releases(int k) const {
    return n(4 * K * U + 4 * K + k);
  }
  // per-task counters: 0 scheduled, 1 correct, 2 misses, 3 units,
  // 4 optional units
  __device__ __forceinline__ int& count(int c, int k) const {
    return n(4 * K * U + (5 + c) * K + k);
  }
};

// Shared-memory words per device.
__host__ __device__ __forceinline__ int replay_table_words(int K, int U) {
  return 4 * K * U + 10 * K;
}

// One device's configuration scalars and replay-table rows.
struct ReplayConfig {
  int policy;
  bool imprecise, is_edfm, persistent, use_exit_thr;
  float eta, alpha, beta, capacity, e_opt, power_on;
  float drift1;      // 1 + clock_drift, as drop_expired forms it
  float threshold;   // policy_threshold(policy)
  const float* margins;   // (K, J, U) rows of this device, replay only
  const unsigned char* passes;
  const unsigned char* correct;
  const float* events;    // (NE,)
  int K, U, J, Q, NE;
  float dt, dt_eps, slot_s;
};

template <int QC, int KC>
struct ReplayState {
  unsigned active, correct, apass;  // bit q: q_active, q_correct, q_apass
  unsigned corr_lp;                 // bit q: the correct table at last_pred
  float release[QC], deadline[QC], time_left[QC], mand_time[QC];
  float margin[QC];
  int task[QC], job[QC], unit[QC], exited[QC], last_pred[QC];
  float gate_e[QC], drain[QC], utility[QC];   // hoisted per slot
  float next_time[KC];                        // next release, +inf when done
  int next_rel[KC];
  float energy, m_busy, m_idle, m_wasted;
  bool was_off;
  int rr_cursor, lock_slot, lock_job, m_reboots;
};

struct ReplayPick {
  int sel;
  bool picked, run;
  float e_new;
};

// a[q] for a run-time q, as a select over the unrolled slots.
template <int N, class V>
__device__ __forceinline__ V sel_get(const V (&a)[N], int q) {
  V v = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (q == i) v = a[i];
  return v;
}

__device__ __forceinline__ bool bit(unsigned m, int q) {
  return (m >> q) & 1u;
}

__device__ __forceinline__ unsigned with_bit(unsigned m, int q, bool v) {
  return v ? (m | (1u << q)) : (m & ~(1u << q));
}

__device__ __forceinline__ int replay_event_slot(const ReplayConfig& g,
                                                 float t) {
  return clampi((int)(t / g.slot_s), 0, g.NE - 1);
}

__device__ inline ReplayConfig replay_config(const ConfigPtrs& c, int d,
                                             int K, int U, int J, int Q,
                                             int NE, float dt, float dt_eps,
                                             float slot_s) {
  ReplayConfig g;
  g.policy = c.policy[d];
  g.imprecise = c.imprecise[d];
  g.is_edfm = c.is_edfm[d];
  g.persistent = c.persistent[d];
  g.use_exit_thr = c.use_exit_thr[d];
  g.eta = c.eta[d];
  g.alpha = c.alpha[d];
  g.beta = c.beta[d];
  g.capacity = c.capacity[d];
  g.e_opt = c.e_opt[d];
  g.power_on = c.power_on[d];
  g.drift1 = 1.f + c.clock_drift[d];
  g.threshold = policy_threshold(g.policy);
  g.margins = nullptr;
  g.passes = nullptr;
  g.correct = nullptr;
  g.events = c.events + (long)d * NE;
  g.K = K;
  g.U = U;
  g.J = J;
  g.Q = Q;
  g.NE = NE;
  g.dt = dt;
  g.dt_eps = dt_eps;
  g.slot_s = slot_s;
  return g;
}

// Copy device d's tables into its shared-memory column, with the per-unit
// gate and drain formed as pick_inputs forms them.
__device__ inline void replay_tables(const ReplayTables& tb,
                                     const ConfigPtrs& c, int d, float e_man,
                                     float dt) {
  const int K = tb.K, U = tb.U;
  for (int k = 0; k < K; ++k) {
    const long o = (long)d * K + k;
    tb.period(k) = c.period[o];
    tb.rel_deadline(k) = c.rel_deadline[o];
    tb.fragments(k) = c.fragments[o];
    tb.n_units(k) = c.n_units[o];
    tb.n_releases(k) = c.n_releases[o];
  }
  for (int k = 0; k < K; ++k) {
    const float frag = tb.fragments(k);
    for (int u = 0; u < U; ++u) {
      const long o = ((long)d * K + k) * U + u;
      const float ut = c.unit_time[o], ue = c.unit_energy[o];
      tb.ut(k, u) = ut;
      tb.gate(k, u) = nan_fmaxf(ue / frag, e_man);
      tb.drain(k, u) = ue * (dt / ut);
      tb.thr(k, u) = c.exit_thr[o];
    }
  }
}

// The hoisted values of slot q from its (task, unit, job, last_pred).
template <bool LIVE, int QC, int KC>
__device__ __forceinline__ void replay_hoist(ReplayState<QC, KC>& s,
                                             const ReplayTables& tb,
                                             const ReplayConfig& g, int q) {
  const int tk = clampi(s.task[q], 0, g.K - 1);
  const int u = clampi(s.unit[q], 0, g.U - 1);
  s.gate_e[q] = tb.gate(tk, u);
  s.drain[q] = tb.drain(tk, u);
  float m;
  bool corr;
  if (LIVE) {
    m = s.margin[q];
    corr = bit(s.correct, q);
  } else {
    const int job = clampi(s.job[q], 0, g.J - 1);
    const int lp = clampi(s.last_pred[q], 0, g.U - 1);
    const long o = ((long)tk * g.J + job) * g.U + lp;
    m = g.margins[o];
    corr = g.correct[o];
  }
  s.utility[q] = s.last_pred[q] >= 0 ? m : 0.f;
  s.corr_lp = with_bit(s.corr_lp, q, corr);
}

template <bool LIVE, int QC, int KC>
__device__ inline void replay_load(ReplayState<QC, KC>& s,
                                   const CarryPtrs& c, const ReplayTables& tb,
                                   const ReplayConfig& g, int d) {
  s.energy = c.energy[d];
  s.was_off = c.was_off[d];
  s.rr_cursor = c.rr_cursor[d];
  s.lock_slot = c.lock_slot[d];
  s.lock_job = c.lock_job[d];
  s.m_reboots = c.m_reboots[d];
  s.m_busy = c.m_busy[d];
  s.m_idle = c.m_idle[d];
  s.m_wasted = c.m_wasted[d];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    s.next_time[k] = INFINITY;
    s.next_rel[k] = 0;
    if (k < g.K) {
      const long o = (long)d * g.K + k;
      tb.count(0, k) = c.m_scheduled[o];
      tb.count(1, k) = c.m_correct[o];
      tb.count(2, k) = c.m_misses[o];
      tb.count(3, k) = c.m_units[o];
      tb.count(4, k) = c.m_optional[o];
      const int nr = c.next_rel[o];
      s.next_rel[k] = nr;
      if (nr < tb.n_releases(k)) s.next_time[k] = (float)nr * tb.period(k);
    }
  }
  s.active = s.correct = s.apass = s.corr_lp = 0u;
#pragma unroll
  for (int q = 0; q < QC; ++q) {
    s.release[q] = s.deadline[q] = s.time_left[q] = s.mand_time[q] = 0.f;
    s.margin[q] = s.gate_e[q] = s.drain[q] = s.utility[q] = 0.f;
    s.task[q] = s.job[q] = s.unit[q] = s.exited[q] = s.last_pred[q] = 0;
    if (q < g.Q) {
      const long o = (long)d * g.Q + q;
      s.active = with_bit(s.active, q, c.q_active[o]);
      s.correct = with_bit(s.correct, q, c.q_correct[o]);
      s.apass = with_bit(s.apass, q, c.q_apass[o]);
      s.release[q] = c.q_release[o];
      s.deadline[q] = c.q_deadline[o];
      s.time_left[q] = c.q_time_left[o];
      s.mand_time[q] = c.q_mand_time[o];
      s.margin[q] = c.q_margin[o];
      s.task[q] = c.q_task[o];
      s.job[q] = c.q_job[o];
      s.unit[q] = c.q_unit[o];
      s.exited[q] = c.q_exited[o];
      s.last_pred[q] = c.q_last_pred[o];
      replay_hoist<LIVE>(s, tb, g, q);
    }
  }
}

template <int QC, int KC>
__device__ inline void replay_store(const ReplayState<QC, KC>& s,
                                    const CarryPtrs& c,
                                    const ReplayTables& tb,
                                    const ReplayConfig& g, int d) {
  c.energy[d] = s.energy;
  c.was_off[d] = s.was_off;
  c.rr_cursor[d] = s.rr_cursor;
  c.lock_slot[d] = s.lock_slot;
  c.lock_job[d] = s.lock_job;
  c.m_reboots[d] = s.m_reboots;
  c.m_busy[d] = s.m_busy;
  c.m_idle[d] = s.m_idle;
  c.m_wasted[d] = s.m_wasted;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if (k < g.K) {
      const long o = (long)d * g.K + k;
      c.m_scheduled[o] = tb.count(0, k);
      c.m_correct[o] = tb.count(1, k);
      c.m_misses[o] = tb.count(2, k);
      c.m_units[o] = tb.count(3, k);
      c.m_optional[o] = tb.count(4, k);
      c.next_rel[o] = s.next_rel[k];
    }
  }
#pragma unroll
  for (int q = 0; q < QC; ++q) {
    if (q < g.Q) {
      const long o = (long)d * g.Q + q;
      c.q_active[o] = bit(s.active, q);
      c.q_correct[o] = bit(s.correct, q);
      c.q_apass[o] = bit(s.apass, q);
      c.q_release[o] = s.release[q];
      c.q_deadline[o] = s.deadline[q];
      c.q_time_left[o] = s.time_left[q];
      c.q_mand_time[o] = s.mand_time[q];
      c.q_margin[o] = s.margin[q];
      c.q_task[o] = s.task[q];
      c.q_job[o] = s.job[q];
      c.q_unit[o] = s.unit[q];
      c.q_exited[o] = s.exited[q];
      c.q_last_pred[o] = s.last_pred[q];
    }
  }
}

// step.finish_counts for one retiring slot, from its values.
__device__ __forceinline__ void replay_finish(const ReplayTables& tb,
                                              const ReplayConfig& g,
                                              float mand_time, float deadline,
                                              int task, int last_pred,
                                              bool corr_bit) {
  const bool sched = mand_time >= 0.f && mand_time <= deadline;
  const int tk = clampi(task, 0, g.K - 1);
  const bool corr = sched && last_pred >= 0 && corr_bit;
  tb.count(0, tk) += sched;
  tb.count(1, tk) += corr;
  tb.count(2, tk) += !sched;
}

template <bool LIVE, int QC, int KC>
__device__ __forceinline__ void replay_finish_slot(
    const ReplayState<QC, KC>& s, const ReplayTables& tb,
    const ReplayConfig& g, int q) {
  replay_finish(tb, g, sel_get(s.mand_time, q), sel_get(s.deadline, q),
                sel_get(s.task, q), sel_get(s.last_pred, q),
                bit(LIVE ? s.correct : s.corr_lp, q));
}

// step.admit: at most one release per task, in task order; on a full
// queue evict the earliest-deadline job whose mandatory part is done.
template <bool LIVE, int QC, int KC>
__device__ __forceinline__ void replay_admit(ReplayState<QC, KC>& s,
                                             const ReplayTables& tb,
                                             const ReplayConfig& g,
                                             float t) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if (k < g.K && s.next_time[k] <= t) {   // releasing
      const int nr = s.next_rel[k];
      const float rel_time = s.next_time[k];
      bool has_free = false, has_evict = false;
      int first_free = 0, victim = 0;
      float vbest = INFINITY;
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        if (q < g.Q) {
          const bool act = bit(s.active, q);
          if (!act && !has_free) {
            has_free = true;
            first_free = q;
          }
          const bool ev = act && s.exited[q] >= 0;
          has_evict |= ev;
          const float key = ev ? s.deadline[q] : INFINITY;
          if (key < vbest) {
            vbest = key;
            victim = q;
          }
        }
      }
      if (!has_free && has_evict) {
        replay_finish_slot<LIVE>(s, tb, g, victim);
        s.active = with_bit(s.active, victim, false);
      }
      s.next_rel[k] = nr + 1;
      s.next_time[k] = nr + 1 < tb.n_releases(k)
                           ? (float)(nr + 1) * tb.period(k) : INFINITY;
      if (has_free || has_evict) {
        const int slot = has_free ? first_free : victim;
        const float deadline = rel_time + tb.rel_deadline(k);
        const float ut = tb.ut(k, 0), gate = tb.gate(k, 0);
        const float drain = tb.drain(k, 0);
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          if (q == slot) {
            s.release[q] = rel_time;
            s.deadline[q] = deadline;
            s.task[q] = k;
            s.job[q] = nr;
            s.unit[q] = 0;
            s.time_left[q] = ut;
            s.exited[q] = -1;
            s.last_pred[q] = -1;
            s.mand_time[q] = -1.f;
            s.margin[q] = 0.f;
            s.gate_e[q] = gate;
            s.drain[q] = drain;
            s.utility[q] = 0.f;
          }
        }
        s.active = with_bit(s.active, slot, true);
        s.correct = with_bit(s.correct, slot, false);
        s.apass = with_bit(s.apass, slot, false);
        s.corr_lp = with_bit(s.corr_lp, slot, false);
      } else {
        tb.count(2, k) += 1;   // queue overflow with nothing evictable
      }
    }
  }
}

// step.drop_expired against the device's drifting clock.
template <bool LIVE, int QC, int KC>
__device__ __forceinline__ void replay_drop_expired(ReplayState<QC, KC>& s,
                                                    const ReplayTables& tb,
                                                    const ReplayConfig& g,
                                                    float t) {
  const float t_read = t * g.drift1;
#pragma unroll
  for (int q = 0; q < QC; ++q) {
    if (q < g.Q && bit(s.active, q) && t_read >= s.deadline[q]) {
      replay_finish(tb, g, s.mand_time[q], s.deadline[q], s.task[q],
                    s.last_pred[q], bit(LIVE ? s.correct : s.corr_lp, q));
      s.active = with_bit(s.active, q, false);
    }
  }
}

// step.pick: policy_scores over the hoisted inputs and select_and_charge;
// `power` is the harvester event of this step times power_on.
template <bool LIVE, int QC, int KC>
__device__ __forceinline__ ReplayPick replay_pick(
    const ReplayState<QC, KC>& s, const ReplayConfig& g, float t,
    float power) {
  const int ls = clampi(s.lock_slot, 0, g.Q - 1);
  const bool locked = s.lock_slot >= 0 && bit(s.active, ls) &&
                      sel_get(s.job, ls) == s.lock_job;
  const int forced = locked ? ls : -1;
  float best = NEG_SCORE;
  int arg = 0;
#pragma unroll
  for (int q = 0; q < QC; ++q) {
    if (q < g.Q) {
      const int tk = clampi(s.task[q], 0, g.K - 1);
      const float rank = (float)floor_mod(tk - s.rr_cursor, g.K);
      const float score = policy_score(
          g.policy, g.persistent, s.deadline[q] - t, s.release[q],
          s.utility[q], s.exited[q] < 0, g.alpha, g.beta, g.eta, s.energy,
          g.e_opt, rank);
      const float sc = bit(s.active, q) ? score : NEG_SCORE;
      if (q == 0) {
        best = sc;
      } else if (sc > best) {
        best = sc;
        arg = q;
      }
    }
  }
  ReplayPick p;
  p.sel = forced >= 0 ? forced : arg;
  p.picked = forced >= 0 || best > g.threshold;
  p.run = p.picked && s.energy >= sel_get(s.gate_e, p.sel);
  p.e_new = nan_fminf(__fmaf_rn(power, g.dt, s.energy), g.capacity) -
            (p.run ? 1.f : 0.f) * sel_get(s.drain, p.sel);
  return p;
}

// step.apply_step: advance the selected slot by dt; on a unit boundary
// test the utility (replay tables, or the live outcome), refresh the
// slot's hoisted values, retire finished jobs and release the lock.
// Returns whether the selected unit completed.
template <bool LIVE, int QC, int KC>
__device__ __forceinline__ bool replay_apply(ReplayState<QC, KC>& s,
                                             const ReplayTables& tb,
                                             const ReplayConfig& g,
                                             float t_end,
                                             const ReplayPick& pk,
                                             const Outcome& out) {
  const int K = g.K, U = g.U;
  const float dt = g.dt;
  const int sel = pk.sel;
  const int task_s = sel_get(s.task, sel), unit_old = sel_get(s.unit, sel);
  const int tk_s = clampi(task_s, 0, K - 1);
  const int u_s = clampi(unit_old, 0, U - 1);
  const bool reboot = pk.run && s.was_off;
  const float idle_inc = (pk.picked && !pk.run) ? dt : 0.f;
  bool complete = false;
  if (pk.run) {
    const float left = sel_get(s.time_left, sel) - dt;
#pragma unroll
    for (int q = 0; q < QC; ++q)
      if (q == sel) s.time_left[q] = left;
    complete = left <= g.dt_eps;
  }
  if (complete) {
    const int next_u = clampi(unit_old + 1, 0, U - 1);
    const int exited_s = sel_get(s.exited, sel);
    const bool mandatory_sel = exited_s < 0;
    const int nu = tb.n_units(tk_s);
    bool passed, corr;
    float margin;
    if (LIVE) {
      margin = out.margin;
      corr = out.correct;
      passed = out.passed;
    } else {
      const int job = clampi(sel_get(s.job, sel), 0, g.J - 1);
      const long kju = ((long)tk_s * g.J + job) * U + u_s;
      margin = g.margins[kju];
      const bool ps = g.passes[kju];
      corr = g.correct[kju];
      passed = g.use_exit_thr ? margin > tb.thr(tk_s, u_s) : ps;
    }
    const bool exit_now = g.imprecise && exited_s < 0 && passed;
    int exited = exit_now ? u_s : exited_s;
    const bool full_mand = exited < 0 && unit_old + 1 >= nu;
    if (full_mand) exited = nu - 1;
    const float mand = (exit_now || full_mand) ? t_end
                                               : sel_get(s.mand_time, sel);
    const bool job_done = unit_old + 1 >= nu || (g.is_edfm && exited >= 0);
    const float ut = tb.ut(tk_s, next_u), gate = tb.gate(tk_s, next_u);
    const float drain = tb.drain(tk_s, next_u);
#pragma unroll
    for (int q = 0; q < QC; ++q) {
      if (q == sel) {
        s.last_pred[q] = u_s;
        s.unit[q] = unit_old + 1;
        s.time_left[q] = ut;
        s.exited[q] = exited;
        s.mand_time[q] = mand;
        s.gate_e[q] = gate;
        s.drain[q] = drain;
        s.utility[q] = margin;   // last_pred = u_s >= 0 from here on
        if (LIVE) s.margin[q] = margin;
      }
    }
    if (LIVE) s.correct = with_bit(s.correct, sel, corr);
    s.corr_lp = with_bit(s.corr_lp, sel, corr);
    if (job_done) {
      replay_finish(tb, g, mand, sel_get(s.deadline, sel), task_s, u_s,
                    corr);
      s.active = with_bit(s.active, sel, false);
    }
    tb.count(3, tk_s) += 1;
    if (!mandatory_sel) tb.count(4, tk_s) += 1;
    if (g.policy == RR_POLICY) s.rr_cursor = floor_mod(tk_s + 1, K);
  }
  const bool lock_on = pk.picked && !complete;
  s.lock_job = lock_on ? sel_get(s.job, sel) : -1;
  s.lock_slot = lock_on ? sel : -1;
  if (reboot && s.m_busy > 0.f) s.m_reboots += 1;
  s.m_busy = s.m_busy + (pk.run ? dt : 0.f);
  s.m_idle = s.m_idle + idle_inc;
  float waste = 0.f;
  if (reboot) waste = 0.5f * (tb.ut(tk_s, u_s) / tb.fragments(tk_s));
  s.m_wasted = s.m_wasted + waste;
  s.energy = pk.e_new;
  s.was_off = pk.run ? false : (pk.picked ? true : s.was_off);
  return complete;
}
