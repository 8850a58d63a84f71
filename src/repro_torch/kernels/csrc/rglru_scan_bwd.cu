// rglru_scan_bwd: the gradient of the RG-LRU's linear recurrence (kernel
// I's backward).
//
// The Pallas TPU kernel repro/kernels/rglru_scan.py:rglru_scan has no
// backward: the reference differentiates XLA's associative scan.  The port
// runs kernel I where that scan was, so training on the card needs I's
// gradient.  For h_t = a_t h_{t-1} + b_t (h_{-1} = h0) and the cotangent dh
// (B, S, W) f32 of h, the recurrence runs in reverse:
//   g_{S-1} = dh_{S-1},  g_t = a_{t+1} g_{t+1} + dh_t,
//   db_t = g_t,  da_t = g_t h_{t-1},  dh0 = a_0 g_0,
// every product and sum one f32 rounding (the library builds with
// -fmad=false): the reference's gradient (jax.vjp of the scan) rounds the
// product and the sum of the reverse chain separately, and so does this,
// bit for bit; so is the plain version
// (repro_torch.kernels.rglru_scan.rglru_scan_bwd_plain).
//
// Bound on the H100: bytes (a, h, dh read once, da and db written once:
// 20 bytes and two flops per element).  Design: one thread per (row, lane),
// the carry g in a register, a reverse loop over S that reads UNROLL steps
// of a, h and dh into registers before the chain's products and sums;
// consecutive threads hold consecutive lanes, so every load and store of a
// step is one coalesced access per warp.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS)
    rglru_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ h0,
                          const float* __restrict__ h,
                          const float* __restrict__ dh, int S, int W,
                          float* __restrict__ da, float* __restrict__ db,
                          float* __restrict__ dh0) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int row = blockIdx.y;
  if (w >= W) return;
  const long base = (long)row * S * W + w;
  float g = 0.f;
  float a_next = 0.f;  // a_{t+1}; 0 past the end, so g_{S-1} = dh_{S-1}
  int t = S - 1;
  for (; t >= UNROLL - 1; t -= UNROLL) {
    float av[UNROLL], hv[UNROLL], gv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long off = base + (long)(t - u) * W;
      av[u] = a[off];
      gv[u] = dh[off];
      hv[u] = t - u > 0 ? h[off - W] : h0[(long)row * W + w];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long off = base + (long)(t - u) * W;
      g = __fadd_rn(__fmul_rn(a_next, g), gv[u]);
      db[off] = g;
      da[off] = __fmul_rn(g, hv[u]);
      a_next = av[u];
    }
  }
  for (; t >= 0; --t) {
    const long off = base + (long)t * W;
    g = __fadd_rn(__fmul_rn(a_next, g), dh[off]);
    db[off] = g;
    da[off] = __fmul_rn(g, t > 0 ? h[off - W] : h0[(long)row * W + w]);
    a_next = a[off];
  }
  dh0[(long)row * W + w] = __fmul_rn(a_next, g);
}

}  // namespace

// a, h, dh (B, S, W) and h0 (B, W) f32, contiguous -> da, db (B, S, W) and
// dh0 (B, W) f32
extern "C" int rglru_scan_bwd_launch(const float* a, const float* h0,
                                     const float* h, const float* dh, int B,
                                     int S, int W, float* da, float* db,
                                     float* dh0, void* stream) {
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, h0, h, dh, S, W, da, db, dh0);
  return (int)cudaGetLastError();
}
