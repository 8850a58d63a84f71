// The L1 summation order of the reference, shared by the l1_topk2 kernel
// (D, l1_topk2.cu), the fused serve kernel's classify (C, serve_fused.cu)
// and pairwise_l1.cu (F).
//
// Summation order.  Every L1 distance is summed in ONE fixed order, the order
// the reference (XLA on the CPU) uses for a float sum over an axis longer
// than 32: the axis is padded with zeros to a multiple of 32 (half the pad in
// front, the rest behind), each window of 32 is summed sequentially, and the
// window sums are summed the same way again until at most 32 remain, which
// are summed sequentially.  Adding a padding zero is exact, so the pad never
// has to be materialised.  The plain PyTorch version
// (repro_torch.kernels.l1_topk2.ordered_sum) takes the same order, so kernels
// and plain versions agree bit for bit.  Build with -fmad=false.
//
// Each level-0 window is its own chain (D and C: l1_chain, summed from a
// tile staged in shared memory with each window at a stride of L1_SLOT
// floats; F: register tiles over staged windows); a centroid's (or an
// output's) window sums then fold into its distance in window order
// (L1Fold), and the top-2 runs over the distances in centroid order
// (L1Top2).  The levels come from kernels/l1_topk2.py:window_plan
// (L1Plan).
#pragma once

#include <cuda_runtime.h>

#define L1_POS 1e30f   // second-minimum mask value of the reference
#define L1_WIN 32      // window of the reference's tree reduction
#define L1_SLOT 33     // staged floats per window: 32 + 1 against bank conflicts

// The levels of the order over d terms, as kernels/l1_topk2.py:window_plan
// gives them: nwin windowed levels (0: d <= 32, one window), lo<l> the
// front padding of level l, n1 the level-0 windows, n2 the level-1 windows.
struct L1Plan {
  int nwin;
  int lo0, lo1, lo2;
  int n1, n2;
};

// Shared-memory position of element e of a staged chunk; shift = lo0 -
// (first window of the chunk) * 32 maps e to its place in the chunk's
// windows, each window at a stride of L1_SLOT floats.
__device__ __forceinline__ int l1_slot(int e, int shift) {
  const int q = e + shift;
  return (q >> 5) * L1_SLOT + (q & 31);
}

// One chain: the sum of window w (of d terms) of |x - c| from 0.f in index
// order over the window's real elements (the padding is skipped: adding
// +0 is exact).  xp and cp point at the window's staged slot.
__device__ __forceinline__ float l1_chain(const float* xp, const float* cp,
                                          const L1Plan& p, int w, int d) {
  const int base = w * L1_WIN - p.lo0;   // element at position 0
  const int jhi = min(L1_WIN, d - base);
  float s = 0.f;
  for (int j = max(0, -base); j < jhi; ++j) s = s + fabsf(xp[j] - cp[j]);
  return s;
}

// A centroid's distance from its level-0 window sums, taken in window
// order: level-1 windows, level-2 windows and the top sum, each summed
// from 0.f in order.
struct L1Fold {
  float acc1 = 0.f, acc2 = 0.f, top = 0.f;
  int cur1 = 0, cur2 = 0;   // the level-1 / level-2 window being summed

  __device__ void add(const L1Plan& p, int w, float v) {
    if (p.nwin <= 1) {        // at most 32 windows: summed in order
      top = top + v;
      return;
    }
    const int w1 = (w + p.lo1) >> 5;
    if (w1 != cur1) {         // w opens the next level-1 window
      up(p, cur1, acc1);
      acc1 = 0.f;
      cur1 = w1;
    }
    acc1 = acc1 + v;
  }

  __device__ float finish(const L1Plan& p) {
    if (p.nwin >= 2) up(p, cur1, acc1);
    return p.nwin == 3 ? top + acc2 : top;
  }

 private:
  // a level-1 window's sum: element i of level 2
  __device__ void up(const L1Plan& p, int i, float v) {
    if (p.nwin == 2) {
      top = top + v;
      return;
    }
    const int w2 = (i + p.lo2) >> 5;
    if (w2 != cur2) {
      top = top + acc2;
      acc2 = 0.f;
      cur2 = w2;
    }
    acc2 = acc2 + v;
  }
};

// The top-2 over distances added in centroid order: d1 the smallest, idx
// its first index, d2 the smallest of the others (L1_POS with one
// centroid): the reference's min / argmin / masked min.
struct L1Top2 {
  float d1 = 0.f, d2 = L1_POS;
  int idx = 0;

  __device__ void add(int cl, float dist) {
    if (cl == 0) {
      d1 = dist;
    } else if (dist < d1) {
      d2 = fminf(d2, d1);
      d1 = dist;
      idx = cl;
    } else {
      d2 = fminf(d2, dist);
    }
  }
};

// The scale-free utility margin of the reference (kmeans.classify).
__device__ __forceinline__ float l1_margin(float d1, float d2) {
  return (d2 - d1) / fmaxf(d1 + d2, 1e-9f);
}
