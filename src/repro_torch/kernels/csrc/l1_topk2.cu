// l1_topk2: per row, the L1 distance to k centroids, the smallest (d1), its
// first index (idx) and the second smallest (d2).
//
// Replaces the Pallas TPU kernel repro/kernels/l1_topk2.py:l1_topk2.
// Bound on the H100: memory.  Each row reads its own d floats and the k
// centroid rows (shared, or one set per row on the serve scan path), and
// does 3 flops per element; at the path's shapes (B <= 250, k = 5, d = 150)
// the whole call moves well under a megabyte, so one launch is dominated by
// launch latency, not by either roofline.
// Design: one thread per row loops over the k centroids and sums the feature
// axis in the reference's fixed order (l1_topk2.cuh), so the result is
// bit-equal to the plain PyTorch version.  No shared memory, no atomics.
#include <cuda_runtime.h>

#include "l1_topk2.cuh"

__global__ void l1_topk2_kernel(const float* __restrict__ x,
                                const float* __restrict__ c, int B, int d,
                                int k, long c_row_stride,
                                float* __restrict__ d1, float* __restrict__ d2,
                                int* __restrict__ idx) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  DenseCentroids cent{c + (long)b * c_row_stride, d};
  l1_top2(x + (long)b * d, d, k, cent, d1 + b, d2 + b, idx + b);
}

// c_per_row = 0: c is one (k, d) block for every row; 1: c is (B, k, d).
extern "C" int l1_topk2_launch(const float* x, const float* c, int B, int d,
                               int k, int c_per_row, float* d1, float* d2,
                               int* idx, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  long stride = c_per_row ? (long)k * d : 0;
  l1_topk2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x, c, B, d, k, stride, d1, d2, idx);
  return (int)cudaGetLastError();
}
