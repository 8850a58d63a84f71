// l1_topk2: per row, the L1 distance to k centroids, the smallest (d1), its
// first index (idx) and the second smallest (d2).
//
// Replaces the Pallas TPU kernel repro/kernels/l1_topk2.py:l1_topk2.
// Bound on the H100: memory, in principle.  Each row reads its own d floats
// and the k centroid rows (shared, or one set per row on the serve scan
// path), and does 3 flops per element; at the path's shapes (B <= 250,
// k = 5, d = 150) the call moves under a megabyte, so what a launch costs is
// latency: the longest chain of dependent adds and the staging loads.
//
// Design: window-parallel chains in the reference's order.  The reference
// (XLA on the CPU) sums the feature axis in zero-padded windows of 32, then
// the window sums in windows of 32 again, until at most 32 terms are summed
// sequentially (l1_topk2.cuh; the plan's levels come from
// kernels/l1_topk2.py:window_plan).  The windows of one level are
// independent chains, so a block takes one row and, per group of up to
// L1_KG centroids and per chunk of the feature axis (one level-1 window, or
// the whole axis when it has at most 32 windows):
//   1. stages the chunk of its x row and of its centroid rows (or of the
//      one shared set) into shared memory with coalesced loads, each window
//      at a stride of 33 floats, so the chains below read distinct banks;
//   2. sums each (centroid, window) chain sequentially from 0.f in index
//      order, skipping the padding zeros (l1_chain; adding +0 is exact);
//   3. folds each centroid's window sums of the chunk in order into its
//      level-1 and level-2 windows and the top sum (L1Fold), one thread per
//      centroid.
// Then thread 0 takes the top-2 over the group's distances in centroid
// order (L1Top2).  The chain, fold and top-2 are l1_topk2.cuh's, which the
// fused serve kernel's warp classify (serve_fused.cu) runs too.  At the
// serve shape the longest chain is 32 + 5 adds instead of 750, over 64 x 5
// x 5 = 1,600 chains.  One row per block and 256 threads were the fastest
// tile at the serve shapes (PERF.md §6): a launch waits on its staging
// loads, so more threads per row pay and more rows per block do not.  No
// float atomics; built with -fmad=false.
#include <cuda_runtime.h>

#include "l1_topk2.cuh"

#define L1_KG 8         // centroids summed per pass over the feature axis
#define L1_THREADS 256  // threads per block (one row)

__global__ void l1_topk2_kernel(const float* __restrict__ x,
                                const float* __restrict__ c, int d, int k,
                                int per_row, L1Plan p, int kg_max,
                                float* __restrict__ d1_out,
                                float* __restrict__ d2_out,
                                int* __restrict__ idx_out) {
  extern __shared__ float sm[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int row = blockIdx.x;
  const int XS = L1_SLOT * min(p.n1, L1_WIN);    // staged floats per row
  float* xs = sm;                                // XS
  float* cs = xs + XS;                           // kg_max x XS
  float* ws = cs + kg_max * XS;                  // kg_max x 33
  float* ds = ws + kg_max * L1_SLOT;             // kg_max
  const int n_chunks = p.nwin >= 2 ? p.n2 : 1;
  const float* xr = x + (long)row * d;
  const float* cr = c + (per_row ? (long)row * k * d : 0L);

  L1Top2 best;                                   // thread 0
  for (int g0 = 0; g0 < k; g0 += kg_max) {
    const int kg = min(kg_max, k - g0);
    L1Fold fold;                                 // thread tid < kg: centroid g0 + tid
    for (int ch = 0; ch < n_chunks; ++ch) {
      int wa = 0, wb = p.n1;                     // level-0 windows [wa, wb)
      if (p.nwin >= 2) {
        wa = max(0, ch * L1_WIN - p.lo1);
        wb = min(p.n1, ch * L1_WIN + L1_WIN - p.lo1);
      }
      const int nw = wb - wa;
      const int e0 = max(0, wa * L1_WIN - p.lo0);
      const int e1 = min(d, wb * L1_WIN - p.lo0);
      const int span = e1 - e0;
      const int shift = p.lo0 - wa * L1_WIN;     // element e -> position e + shift
      __syncthreads();                           // last chunk's reads are done
      for (int e = e0 + tid; e < e1; e += T) xs[l1_slot(e, shift)] = xr[e];
      for (int i = tid; i < kg * span; i += T) {
        const int cl = i / span, e = e0 + i - cl * span;
        cs[cl * XS + l1_slot(e, shift)] = cr[(long)(g0 + cl) * d + e];
      }
      __syncthreads();
      // one chain per (centroid, window), window fastest
      for (int i = tid; i < kg * nw; i += T) {
        const int cl = i / nw, w = i - cl * nw;
        ws[cl * L1_SLOT + w] = l1_chain(xs + w * L1_SLOT,
                                        cs + cl * XS + w * L1_SLOT, p,
                                        wa + w, d);
      }
      __syncthreads();
      if (tid < kg)
        for (int w = 0; w < nw; ++w)
          fold.add(p, wa + w, ws[tid * L1_SLOT + w]);
    }
    if (tid < kg) ds[tid] = fold.finish(p);
    __syncthreads();
    if (tid == 0)
      for (int cl = 0; cl < kg; ++cl) best.add(g0 + cl, ds[cl]);
  }
  if (tid == 0) {
    d1_out[row] = best.d1;
    d2_out[row] = best.d2;
    idx_out[row] = best.idx;
  }
}

// c_per_row = 0: c is one (k, d) block for every row; 1: c is (B, k, d).
// plan = {nwin, lo0, lo1, lo2, n1, n2}.
extern "C" int l1_topk2_launch(const float* x, const float* c, int B, int d,
                               int k, int c_per_row, const int* plan,
                               float* d1, float* d2, int* idx, void* stream) {
  L1Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const int kg = min(k, L1_KG);
  const int XS = L1_SLOT * min(p.n1, L1_WIN);
  const int smem = 4 * ((1 + kg) * XS + kg * L1_SLOT + kg);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        l1_topk2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  l1_topk2_kernel<<<B, L1_THREADS, smem, (cudaStream_t)stream>>>(
      x, c, d, k, c_per_row, p, kg, d1, d2, idx);
  return (int)cudaGetLastError();
}
