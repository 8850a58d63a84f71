// centroid_update: c_j <- (w * c_j + sum_{i: a_i = j} x_i) / (w + n_j).
//
// Replaces the Pallas TPU kernel repro/kernels/centroid_update.py:
// centroid_update (a one-hot matmul on the MXU).
// Bound on the H100: memory.  It reads c (k*d) and x (B*d) once and writes
// k*d floats, at under one flop per byte.
// Design: one thread per (cluster j, column f) sums the rows assigned to j
// in the reference's order (kernels/centroid_update.py:row_blocks): the
// rows, padded to a multiple of 8, split into P = ceil(N / 608) parts of
// 8 * ceil(N / 8P) rows (the last takes the rest), a part longer than 384
// rows into two halves; each block sums in row order from zero and the
// block sums are added in order.  A deterministic reduction with no float
// atomics, bit-equal to the plain PyTorch version.  Rows whose assignment
// is < 0 (or >= k) are ignored, so the fleet caller needs no one-hot.
// Neighbouring threads read neighbouring columns of each row, so the x
// loads coalesce.  Built with -fmad=false; the reference's one fused
// multiply-add (w * c_j + sum) is written out as __fmaf_rn, and the
// division stays an IEEE division.
#include <cuda_runtime.h>

__device__ float block_sum(const float* __restrict__ x,
                           const int* __restrict__ assign, int B, int j,
                           int d, int f, int start, int end) {
  float s = 0.f;
  int stop = end < B ? end : B;  // rows >= B are the zero padding
  for (int b = start; b < stop; ++b)
    if (assign[b] == j) s = __fadd_rn(s, x[(long)b * d + f]);
  return s;
}

__global__ void centroid_update_kernel(const float* __restrict__ c,
                                       const float* __restrict__ x,
                                       const int* __restrict__ assign, int B,
                                       int k, int d, float w,
                                       float* __restrict__ out) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)k * d) return;
  int j = (int)(t / d);
  int f = (int)(t % d);
  int n8 = (B + 7) / 8 * 8;
  int n_parts = (n8 + 607) / 608;
  int part = 8 * ((n8 + 8 * n_parts - 1) / (8 * n_parts));
  float s = 0.f;
  int start = 0;
  for (int p = 0; p < n_parts; ++p) {
    int size = p + 1 < n_parts ? part : n8 - (n_parts - 1) * part;
    if (size > 384) {
      s = __fadd_rn(s, block_sum(x, assign, B, j, d, f, start,
                                 start + size / 2));
      s = __fadd_rn(s, block_sum(x, assign, B, j, d, f, start + size / 2,
                                 start + size));
    } else {
      s = __fadd_rn(s, block_sum(x, assign, B, j, d, f, start,
                                 start + size));
    }
    start += size;
  }
  float n = 0.f;
  for (int b = 0; b < B; ++b) n += assign[b] == j ? 1.f : 0.f;
  out[t] = __fdiv_rn(__fmaf_rn(w, c[t], s), __fadd_rn(w, n));
}

extern "C" int centroid_update_launch(const float* c, const float* x,
                                      const int* assign, int B, int k, int d,
                                      float w, float* out, void* stream) {
  const int threads = 256;
  long n = (long)k * d;
  int blocks = (int)((n + threads - 1) / threads);
  centroid_update_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      c, x, assign, B, k, d, w, out);
  return (int)cudaGetLastError();
}
