// The pure helpers of the per-device step core (repro_torch/core/step.py):
// the pointer structs of the step's configuration and carry, the policy
// score of one slot, the pick's selection and capacitor charge
// (select_and_charge), the NaN-propagating clamp and floor, and the small
// integer helpers.
//
// Used by
//   fleet_priority.cu  (A) — policy_score + select_and_charge, the pick of
//                            one fleet step;
//   replay_step.cuh        — the step's stages (admit -> drop-expired ->
//                            pick -> apply) with the carry in registers,
//                            which kernels B (fleet_fused.cu, replay) and C
//                            (serve_fused.cu, live) run: one copy of each
//                            stage, as the reference's single device_step
//                            serves its two fused kernels.
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

// torch.minimum / torch.maximum (and jnp's): NaN if either operand is NaN,
// where fminf / fmaxf would return the other operand.  The capacitor clamp
// and the energy gate's floor use them, so a NaN charge (0 x inf, from a
// unit of zero time) stays NaN as in the plain version and the reference.
__device__ __forceinline__ float nan_fminf(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float nan_fmaxf(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
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
  p.e_new = nan_fminf(__fmaf_rn(power, dt, energy), capacity) -
            (p.run ? 1.f : 0.f) * drain[p.sel];
  return p;
}

__device__ __forceinline__ float policy_threshold(int policy) {
  return policy == 0 ? 0.f : (float)(0.5 * -1e30);
}
