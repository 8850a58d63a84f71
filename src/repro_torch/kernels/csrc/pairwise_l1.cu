// pairwise_l1: the (B1, B2) all-pairs L1 distance matrix of x (B1, d) and
// y (B2, d), float32.
//
// Replaces the Pallas TPU kernel repro/kernels/pairwise_l1.py:pairwise_l1.
// Summation order.  The reference reads the feature axis in blocks of
// bd = min(block_d, d) columns (the last block zero-padded to bd), reduces
// each block on its own in the fixed window-32 order of l1_topk2.cuh, and
// adds the block sums in order into a zeroed output.  This kernel takes the
// same order: one OrderedSum per block, the block sums added one by one
// starting from 0.  Padding zeros add nothing, so they are never read; the
// window layout still comes from the padded width bd.  Build with
// -fmad=false; the subtraction and every add are single f32 roundings, and
// there are no float atomics, so the result is bit-equal to the plain
// PyTorch version (repro_torch.kernels.pairwise_l1.pairwise_l1_plain).
//
// Bound on the H100: operations.  Each of the B1*B2*d terms is a subtract,
// an absolute value and an add (3 f32 operations); the inputs are read once
// from device memory and the (B1, B2) output written once, so at the
// forecaster's shapes the call is launch-bound and at large B1, B2 the f32
// rate bounds it.
// Design: a 16 x 16 block of threads computes a 16 x 16 tile of the output,
// one thread per (i, j).  The x and y rows of the tile are staged through
// shared memory 32 columns at a time (one window of the reduction), loaded
// by neighbouring threads from neighbouring addresses; each thread then
// streams its 32 terms in column order into its OrderedSum.  Simple first:
// the window bookkeeping of OrderedSum costs integer work per term.
#include <cuda_runtime.h>

#include "l1_topk2.cuh"

#define PW_TILE 16
#define PW_KC 32

__global__ void pairwise_l1_kernel(const float* __restrict__ x,
                                   const float* __restrict__ y, int B1,
                                   int B2, int d, int bd,
                                   float* __restrict__ out) {
  __shared__ float xs[PW_TILE][PW_KC + 1];
  __shared__ float ys[PW_TILE][PW_KC + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = blockIdx.y * PW_TILE + ty;   // output row (x row)
  const int j = blockIdx.x * PW_TILE + tx;   // output column (y row)
  // the rows this thread stages: x row of its ty, y row of its ty
  const int xi = blockIdx.y * PW_TILE + ty;
  const int yj = blockIdx.x * PW_TILE + ty;
  float total = 0.f;
  for (int base = 0; base < d; base += bd) {
    const int len = min(bd, d - base);       // real columns of this block
    OrderedSum s(bd);
    for (int k0 = 0; k0 < len; k0 += PW_KC) {
      for (int kk = tx; kk < PW_KC; kk += PW_TILE) {
        const int k = k0 + kk;
        const bool in = k < len;
        xs[ty][kk] = (in && xi < B1) ? x[(long)xi * d + base + k] : 0.f;
        ys[ty][kk] = (in && yj < B2) ? y[(long)yj * d + base + k] : 0.f;
      }
      __syncthreads();
      const int kn = min(PW_KC, len - k0);
      for (int kk = 0; kk < kn; ++kk)
        s.add(0, k0 + kk, fabsf(__fsub_rn(xs[ty][kk], ys[tx][kk])));
      __syncthreads();
    }
    total = __fadd_rn(total, s.finish());
  }
  if (i < B1 && j < B2) out[(long)i * B2 + j] = total;
}

extern "C" int pairwise_l1_launch(const float* x, const float* y, int B1,
                                  int B2, int d, int bd, float* out,
                                  void* stream) {
  dim3 threads(PW_TILE, PW_TILE);
  dim3 blocks((B2 + PW_TILE - 1) / PW_TILE, (B1 + PW_TILE - 1) / PW_TILE);
  pairwise_l1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x, y, B1, B2, d, bd, out);
  return (int)cudaGetLastError();
}
