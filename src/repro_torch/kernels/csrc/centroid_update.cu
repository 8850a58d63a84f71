// centroid_update: c_j <- (w * c_j + sum_{i: a_i = j} x_i) / (w + n_j).
//
// Replaces the Pallas TPU kernel repro/kernels/centroid_update.py:
// centroid_update (a one-hot matmul on the MXU).
// Bound on the H100: memory.  It reads c (k*d) and x (B*d) once and writes
// k*d floats, at under one flop per byte.
// Design: one thread per (cluster j, column f) walks the B rows in order and
// sums the rows assigned to j sequentially: a deterministic reduction with no
// float atomics, bit-equal to the plain PyTorch version.  Rows whose
// assignment is < 0 (or >= k) are ignored, so the fleet caller needs no
// one-hot.  Neighbouring threads read neighbouring columns of each row, so
// the x loads coalesce.  Build with -fmad=false: w * c and the sum are two
// roundings, and the division stays an IEEE division.
#include <cuda_runtime.h>

__global__ void centroid_update_kernel(const float* __restrict__ c,
                                       const float* __restrict__ x,
                                       const int* __restrict__ assign, int B,
                                       int k, int d, float w,
                                       float* __restrict__ out) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)k * d) return;
  int j = (int)(t / d);
  int f = (int)(t % d);
  float s = 0.f;
  float n = 0.f;
  for (int b = 0; b < B; ++b) {
    if (assign[b] == j) {
      s = s + x[(long)b * d + f];
      n = n + 1.f;
    }
  }
  out[t] = (w * c[t] + s) / (w + n);
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
