// fleet_priority: the fleet simulator's per-step pick for every device in
// ONE launch — policy scores of the Q queue slots with the round-robin rank
// (task - cursor) mod K, first-index argmax, the forced (locked) slot, the
// threshold test, the energy gate and the capacitor charge/discharge
// (repro_torch/core/policy.py:policy_scores + core/step.py:
// select_and_charge).
//
// Replaces the Pallas TPU kernel repro/kernels/fleet_priority.py:
// fleet_priority.
// Bound on the H100: latency and launch overhead.  Per device it reads
// 8 (D, Q) and 11 (D,) operands and writes 4 (D,) results — about 30 B per
// slot — and does a few tens of operations per slot, so at the paper's
// fleet sizes the bytes take well under a microsecond and a launch costs
// more than the work.
// Design: one thread per device with its Q <= 8 slots in registers; the
// score is device_step.cuh's policy_score, which the fused kernels' pick
// runs too, and select_and_charge clamps the charge with the same
// NaN-keeping nan_fminf, so kernels A, B and C make one pick with the same
// bits.  Booleans stay one byte.  An odd D needs no padding: threads with
// d >= D return.  The body is not the lever: its device time is about a
// launch's floor, and a call's cost is the wrapper's host work
// (kernels/fleet_priority.py).  Build with -fmad=false.
#include "device_step.cuh"

// Keep the field order in sync with repro_torch/kernels/fleet_priority.py
// (_PriorityArgs); priority_args_size() lets the wrapper check the layout.
struct PriorityArgs {
  // (D,)
  const int* policy;
  const float* alpha;
  const float* beta;
  const float* eta;
  const unsigned char* persistent;
  const float* energy;
  const float* e_opt;
  const float* power;
  const float* capacity;
  const int* forced;
  const int* rr_cursor;
  // (D, Q)
  const unsigned char* active;
  const float* laxity;
  const float* release;
  const float* utility;
  const unsigned char* mandatory;
  const float* gate_e;
  const float* drain;
  const int* task;
  // outputs, (D,)
  int* sel;
  unsigned char* picked;
  unsigned char* run;
  float* e_new;
  int D, Q, n_tasks;
  float dt;
};

__global__ void fleet_priority_kernel(const PriorityArgs a) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= a.D) return;
  const int Q = a.Q;
  const int policy = a.policy[d];
  const bool persistent = a.persistent[d];
  const float alpha = a.alpha[d], beta = a.beta[d], eta = a.eta[d];
  const float energy = a.energy[d], e_opt = a.e_opt[d];
  const int cursor = a.rr_cursor[d];
  float scores[QMAX], gate_e[QMAX], drain[QMAX];
  for (int q = 0; q < Q; ++q) {
    const long o = (long)d * Q + q;
    const float rank = (float)floor_mod(a.task[o] - cursor, a.n_tasks);
    const float score = policy_score(
        policy, persistent, a.laxity[o], a.release[o], a.utility[o],
        a.mandatory[o], alpha, beta, eta, energy, e_opt, rank);
    scores[q] = a.active[o] ? score : NEG_SCORE;
    gate_e[q] = a.gate_e[o];
    drain[q] = a.drain[o];
  }
  const PickResult p = select_and_charge(
      scores, Q, policy_threshold(policy), a.forced[d], energy, a.power[d],
      a.capacity[d], gate_e, drain, a.dt);
  a.sel[d] = p.sel;
  a.picked[d] = p.picked;
  a.run[d] = p.run;
  a.e_new[d] = p.e_new;
}

extern "C" int priority_args_size() { return (int)sizeof(PriorityArgs); }

extern "C" int fleet_priority_launch(const PriorityArgs* args, int threads,
                                     void* stream) {
  PriorityArgs a = *args;
  int blocks = (a.D + threads - 1) / threads;
  fleet_priority_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
