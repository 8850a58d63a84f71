// decode_gqa: one-token GQA attention against a ring-buffer KV cache
// (kernel H).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_gqa.py:decode_gqa.
// q (B, H, hd), caches (B, C, KV, hd) in f32 or bf16, slot_pos (B, C) and
// my_pos (B,) int32 -> out (B, H, hd) f32; G = H / KV query heads share a
// kv head.  Scores are f32 q.k * hd^-0.5, -1e30 where the slot is invalid
// (valid iff 0 <= slot <= pos, and pos - slot <= window when window > 0).
// round_p = 0 computes the Pallas kernel's function: sum_c p_c v_c / max(l,
// 1e-30) with p_c = exp(s_c - m), l = sum_c p_c (a query with no valid slot
// takes p = 1 everywhere and l = the reference's padded slot count).
// round_p = 1 computes the model's decode_attention: p_c = exp(s_c - m) / l
// rounded to the cache's dtype, out = sum_c p_c v_c.
//
// Bound on the H100: bytes (the k and v rows of the valid slots are read
// once: 2 * n_valid * hd elements per (row, kv head) against
// 4 * G * n_valid * hd flops), far below the f32 rate at these sizes; with one block per (row, kv head) a decode at
// batch 1 runs on one SM, so it is latency-bound in practice.
//
// Design: one block of 256 threads per (batch row, kv head); the G query
// heads of the group sit in shared memory as f32.  Pass 1 stages 64-slot
// tiles of k (converted to f32 in registers, zero-filled past C) in shared
// memory and computes the G x 64 scores with threads over (head, slot),
// each a sequential __fmaf_rn dot over d = 0 .. hd-1; masked scores are
// -1e30; scores go to a global scratch (B, KV, G, C) that the wrapper
// allocates.  Pass 2 gives each query head to one warp: its max, then
// p = exp(s - m) and their sum l, each lane over slots lane, lane + 32, ...
// in order and the lanes joined by a fixed xor tree (no float atomics),
// then for round_p the normalised, rounded p written back.  exp and the
// sum are taken in f64 and rounded to f32: exp then rounds as the plain
// version's f64 exp does, and the sum's f32 value does not depend on its
// order (its f64 error is far below an f32 ulp), so the plain version,
// which forms each score in the same order, gets the same weights bit for
// bit, and a weight rounded to bf16 cannot land on the other side of a
// rounding boundary in one version only.  Pass 3 stages 64-slot tiles of p
// and of v (read as stored, coalesced, converted to f32) in shared memory;
// thread d owns output column d and sums p_c * v[c, d] over the slots in
// order for every head of the group.  The library builds with -fmad=false;
// every multiply-add here is an explicit __fmaf_rn.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;     // cache slots per shared tile
constexpr int GMAX = 32;     // largest query group
constexpr float NEG = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p rounded to the cache's dtype (the reference's p.astype(v.dtype))
template <typename T>
__device__ __forceinline__ float round_like(float p);
template <>
__device__ __forceinline__ float round_like<float>(float p) { return p; }
template <>
__device__ __forceinline__ float round_like<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Stage rows c0 .. c0 + TILE - 1 (zeros past C) of a cache's ``width``
// columns, converted to f32, at dst[row * dst_stride + col].
template <typename T>
__device__ __forceinline__ void stage_tile(float* dst, int dst_stride,
                                           const T* src, long src_stride,
                                           int c0, int C, int width) {
  for (int i = threadIdx.x; i < TILE * width; i += THREADS) {
    const int r = i / width, d = i % width;
    dst[r * dst_stride + d] =
        c0 + r < C ? to_f32(src[(long)(c0 + r) * src_stride + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ slot_pos,
                      const int* __restrict__ my_pos, int C, int H, int KV,
                      int hd, int window, int round_p, float scale,
                      float ref_count, float* scratch,
                      float* __restrict__ out) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int ks = hd + 1;                       // padded k row stride
  float* Qs = smem;                            // G x hd
  float* Ts = Qs + G * hd;                     // k tile, then v tile
  float* Ps = Ts + TILE * ks;                  // G x TILE weights
  float* den = Ps + G * TILE;                  // G denominators

  const int row = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int pos = my_pos[row];
  const long cstride = (long)KV * hd;          // cache stride per slot
  const T* kr = k + (long)row * C * cstride + (long)kvh * hd;
  const T* vr = v + (long)row * C * cstride + (long)kvh * hd;
  const int* sp = slot_pos + (long)row * C;
  float* sc = scratch + ((long)row * KV + kvh) * G * C;

  // the group's query heads kvh*G .. kvh*G + G - 1 are contiguous in q
  const T* qr = q + ((long)row * H + (long)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += THREADS) Qs[i] = to_f32(qr[i]);

  // ---- pass 1: scores ----------------------------------------------------
  for (int c0 = 0; c0 < C; c0 += TILE) {
    __syncthreads();  // Qs written / the previous tile consumed
    stage_tile(Ts, ks, kr, cstride, c0, C, hd);
    __syncthreads();
    for (int i = tid; i < G * TILE; i += THREADS) {
      const int g = i / TILE, cc = i % TILE;
      const int c = c0 + cc;
      if (c >= C) continue;
      const float* qg = Qs + g * hd;
      const float* kc = Ts + cc * ks;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = __fmaf_rn(qg[d], kc[d], s);
      const int p = sp[c];
      const bool valid =
          p >= 0 && p <= pos && (window == 0 || pos - p <= window);
      sc[(long)g * C + c] = valid ? __fmul_rn(s, scale) : NEG;
    }
  }
  __syncthreads();  // every score is in the scratch

  // ---- pass 2: softmax weights, one warp per query head ------------------
  const int warp = tid >> 5, lane = tid & 31;
  for (int g = warp; g < G; g += THREADS / 32) {
    float* sg = sc + (long)g * C;
    float m = NEG;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, sg[c]);
    m = warp_max(m);
    double ld = 0.0;
    for (int c = lane; c < C; c += 32) {
      const float p = (float)exp((double)__fsub_rn(sg[c], m));
      sg[c] = p;
      ld = __dadd_rn(ld, (double)p);
    }
    float l = (float)warp_sum(ld);
    if (round_p) {
      for (int c = lane; c < C; c += 32)
        sg[c] = round_like<T>(__fdiv_rn(sg[c], l));
    } else if (m == NEG) {
      l = ref_count;  // no valid slot: the reference's padded count
    }
    if (lane == 0) den[g] = fmaxf(l, 1e-30f);
  }

  // ---- pass 3: out = p @ v, thread d owns column d -----------------------
  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
  for (int c0 = 0; c0 < C; c0 += TILE) {
    __syncthreads();  // pass 2's weights / the previous tiles consumed
    for (int i = tid; i < G * TILE; i += THREADS) {
      const int g = i / TILE, cc = i % TILE;
      const int c = c0 + cc;
      Ps[i] = c < C ? sc[(long)g * C + c] : 0.f;
    }
    stage_tile(Ts, hd, vr, cstride, c0, C, hd);
    __syncthreads();
    if (tid < hd) {
      const int n = min(TILE, C - c0);
      for (int cc = 0; cc < n; ++cc) {
        const float vv = Ts[cc * hd + tid];
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) acc[g] = __fmaf_rn(Ps[g * TILE + cc], vv, acc[g]);
      }
    }
  }
  if (tid < hd) {
    float* o = out + ((long)row * H + (long)kvh * G) * hd + tid;
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) o[(long)g * hd] = round_p ? acc[g] : __fdiv_rn(acc[g], den[g]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* slot_pos,
           const int* my_pos, int B, int C, int H, int KV, int hd,
           int window, int round_p, float scale, float ref_count,
           float* scratch, float* out, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) * ((size_t)G * hd + TILE * (hd + 1) +
                                       (size_t)G * TILE + GMAX);
  auto kern = decode_gqa_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B * KV, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, slot_pos, my_pos, C, H, KV, hd,
      window, round_p, scale, ref_count, scratch, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_gqa_launch(const void* q, const void* k, const void* v,
                                 const int* slot_pos, const int* my_pos,
                                 int B, int C, int H, int KV, int hd,
                                 int window, int round_p, float scale,
                                 float ref_count, int bf16, float* scratch,
                                 float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, slot_pos, my_pos, B, C, H, KV, hd,
                                 window, round_p, scale, ref_count, scratch,
                                 out, st);
  return launch<float>(q, k, v, slot_pos, my_pos, B, C, H, KV, hd, window,
                       round_p, scale, ref_count, scratch, out, st);
}
