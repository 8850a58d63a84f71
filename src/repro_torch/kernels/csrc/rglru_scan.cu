// rglru_scan: the RG-LRU's diagonal linear recurrence (kernel I).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py:rglru_scan.
// a, b (B, S, W) f32 and h0 (B, W) f32 -> h (B, S, W) f32 and h_last (B, W)
// f32 with h_t = a_t * h_{t-1} + b_t, formed as one fused multiply-add
// (__fmaf_rn), as the reference kernel and its oracle form it on the CPU;
// the library builds with -fmad=false, so no other product is contracted.
// The result is bit-equal to the plain PyTorch version
// (repro_torch.kernels.rglru_scan.rglru_scan_plain).
//
// Bound on the H100: bytes (a and b read once, h written once: 12 bytes
// and one FMA per element), but a lane's S steps form one dependent chain,
// so at B * W = 4,096 lanes (the prefill) the chain's latency decides.
//
// Design: one thread per (batch row, width lane), the carry h in a
// register.  The loop over S reads a[b, t, w] and b[b, t, w], coalesced
// across the warp's neighbouring w, and writes h[b, t, w].  The loads of a
// chunk of CHUNK steps are issued before its FMAs, so a thread keeps
// 2 * CHUNK loads in flight while its chain runs.  Ragged B and W are
// bounds-checked; nothing is padded.  Splitting S into chunks with a carry
// pass (more lanes in flight) is a later optimisation.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int CHUNK = 8;

__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ h0, int S, int W,
                      float* __restrict__ h_out,
                      float* __restrict__ h_last) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int row = blockIdx.y;
  if (w >= W) return;
  float h = h0[(long)row * W + w];
  const long base = (long)row * S * W + w;
  int t = 0;
  for (; t + CHUNK <= S; t += CHUNK) {
    float av[CHUNK], bv[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const long off = base + (long)(t + i) * W;
      av[i] = a[off];
      bv[i] = b[off];
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      h = __fmaf_rn(av[i], h, bv[i]);
      h_out[base + (long)(t + i) * W] = h;
    }
  }
  for (; t < S; ++t) {
    const long off = base + (long)t * W;
    h = __fmaf_rn(a[off], h, b[off]);
    h_out[off] = h;
  }
  h_last[(long)row * W + w] = h;
}

}  // namespace

extern "C" int rglru_scan_launch(const float* a, const float* b,
                                 const float* h0, int B, int S, int W,
                                 float* h_out, float* h_last, void* stream) {
  dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, h0, S, W, h_out, h_last);
  return (int)cudaGetLastError();
}
