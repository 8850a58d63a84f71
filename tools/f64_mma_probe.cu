// f64 tensor-core probe for sm_90a: checks the fragment layouts kernel G's
// score products assume for mma.sync m8n8k4 / m16n8k4 / m16n8k8 /
// m16n8k16 with f64 operands (each against a CPU product of small integer
// matrices, which f64 sums exactly), then times each shape's rate on a
// full card (528 blocks of 4 or 8 warps, 8 independent accumulators).
//
//   mkdir -p src/repro_torch/kernels/build && nvcc -gencode \
//       arch=compute_90a,code=sm_90a -O3 -o \
//       src/repro_torch/kernels/build/f64_mma_probe tools/f64_mma_probe.cu \
//       && src/repro_torch/kernels/build/f64_mma_probe
#include <cstdio>
#include <cmath>
#include <cuda_runtime.h>

__global__ void k884(const double* A, const double* B, double* D) {  // 8x4, 4x8
  int l = threadIdx.x, g = l >> 2, t = l & 3;
  double a = A[g * 4 + t], b = B[t * 8 + g], d0 = 0, d1 = 0;
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1},{%2},{%3},{%0,%1};" : "+d"(d0), "+d"(d1) : "d"(a), "d"(b));
  D[g * 8 + 2 * t] = d0; D[g * 8 + 2 * t + 1] = d1;
}
__global__ void k1684(const double* A, const double* B, double* D) {  // 16x4, 4x8
  int l = threadIdx.x, g = l >> 2, t = l & 3;
  double a0 = A[g * 4 + t], a1 = A[(g + 8) * 4 + t], b = B[t * 8 + g];
  double d[4] = {0, 0, 0, 0};
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5},{%6},{%0,%1,%2,%3};" : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a0), "d"(a1), "d"(b));
  D[g * 8 + 2 * t] = d[0]; D[g * 8 + 2 * t + 1] = d[1]; D[(g + 8) * 8 + 2 * t] = d[2]; D[(g + 8) * 8 + 2 * t + 1] = d[3];
}
__global__ void k1688(const double* A, const double* B, double* D) {  // 16x8, 8x8
  int l = threadIdx.x, g = l >> 2, t = l & 3;
  double a[4], b[2], d[4] = {0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) a[i] = A[(g + 8 * (i & 1)) * 8 + t + 4 * (i >> 1)];
  for (int i = 0; i < 2; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5,%6,%7},{%8,%9},{%0,%1,%2,%3};" : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  D[g * 8 + 2 * t] = d[0]; D[g * 8 + 2 * t + 1] = d[1]; D[(g + 8) * 8 + 2 * t] = d[2]; D[(g + 8) * 8 + 2 * t + 1] = d[3];
}
__global__ void k16816(const double* A, const double* B, double* D) {  // 16x16, 16x8
  int l = threadIdx.x, g = l >> 2, t = l & 3;
  double a[8], b[4], d[4] = {0, 0, 0, 0};
  for (int i = 0; i < 8; ++i) a[i] = A[(g + 8 * (i & 1)) * 16 + t + 4 * (i >> 1)];
  for (int i = 0; i < 4; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5,%6,%7,%8,%9,%10,%11},{%12,%13,%14,%15},{%0,%1,%2,%3};" : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  D[g * 8 + 2 * t] = d[0]; D[g * 8 + 2 * t + 1] = d[1]; D[(g + 8) * 8 + 2 * t] = d[2]; D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

template <int KIND>
__global__ void thru(double* out, int iters) {
  double acc[8][4] = {};
  double a = threadIdx.x * 1e-3, b = 1.0 + blockIdx.x * 1e-6;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1},{%2},{%3},{%0,%1};" : "+d"(acc[j][0]), "+d"(acc[j][1]) : "d"(a), "d"(b));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%4,%4,%4,%4,%4,%4,%4},{%5,%5,%5,%5},{%0,%1,%2,%3};" : "+d"(acc[j][0]), "+d"(acc[j][1]), "+d"(acc[j][2]), "+d"(acc[j][3]) : "d"(a), "d"(b));
    }
  }
  double s = 0; for (int j = 0; j < 8; ++j) for (int i = 0; i < 4; ++i) s += acc[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int check(const char* name, void (*kern)(const double*, const double*, double*), int M, int K) {
  double hA[256], hB[128], hD[128], ref[128];
  for (int i = 0; i < M * K; ++i) hA[i] = (i * 7 % 13) - 6 + 0.25 * (i % 3);
  for (int i = 0; i < K * 8; ++i) hB[i] = (i * 5 % 11) - 5 + 0.5 * (i % 2);
  for (int m = 0; m < M; ++m) for (int n = 0; n < 8; ++n) { double s = 0; for (int k = 0; k < K; ++k) s += hA[m * K + k] * hB[k * 8 + n]; ref[m * 8 + n] = s; }
  double *A, *B, *D; cudaMalloc(&A, 2048); cudaMalloc(&B, 1024); cudaMalloc(&D, 1024);
  cudaMemcpy(A, hA, 8 * M * K, cudaMemcpyHostToDevice); cudaMemcpy(B, hB, 8 * K * 8, cudaMemcpyHostToDevice);
  kern<<<1, 32>>>(A, B, D); cudaError_t e = cudaDeviceSynchronize();
  cudaMemcpy(hD, D, 8 * M * 8, cudaMemcpyDeviceToHost);
  double err = 0; for (int i = 0; i < M * 8; ++i) err = fmax(err, fabs(hD[i] - ref[i]));
  printf("%s: %s, max err %g\n", name, cudaGetErrorString(e), err);
  return err == 0;
}

int main() {
  check("m8n8k4", k884, 8, 4); check("m16n8k4", k1684, 16, 4);
  check("m16n8k8", k1688, 16, 8); check("m16n8k16", k16816, 16, 16);
  double* out; cudaMalloc(&out, 132 * 8 * 128 * 8);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  int iters = 4096;
  for (int kind = 0; kind < 2; ++kind) for (int wpb : {4, 8}) {
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(a);
      if (kind == 0) thru<0><<<132 * 4, 32 * wpb>>>(out, iters); else thru<1><<<132 * 4, 32 * wpb>>>(out, iters);
      cudaEventRecord(b); cudaEventSynchronize(b);
      float ms; cudaEventElapsedTime(&ms, a, b);
      double flop = 132.0 * 4 * wpb * iters * 8 * (kind == 0 ? 512.0 : 4096.0);
      if (rep) printf("%s, %d warps/block: %.1f TFLOP/s f64\n", kind ? "m16n8k16" : "m8n8k4", wpb, flop / ms / 1e9);
    }
  }
  return 0;
}
