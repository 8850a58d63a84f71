// flash_attn: GQA online-softmax attention forward (kernel G).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py:
// flash_attention.  q (B, S, H, hd), k/v (B, Skv, KV, hd) in f32 or bf16
// -> out (B, S, H, hd) f32; G = H / KV query heads share a kv head.
// Scores are f32 q.k * hd^-0.5 with -1e30 on masked pairs (causal:
// qpos >= kpos; window: qpos - kpos <= window; kpos < Skv), the softmax
// runs online over 64-key tiles in ascending order (running max m,
// denominator l, f32 accumulator), p is rounded to v's dtype before the PV
// product, and out = acc / max(l, 1e-30).
//
// Bound on the H100: operations (4 * S * Skv_visible * hd flops per head
// against ~2 bytes per element of q, k, v and 4 of the output).
//
// Design: one block of 128 threads per (64 query rows, batch x kv head);
// a query row is (position, head of the kv group), so a block covers 64/G
// positions and all G heads, and each k/v tile is loaded once into shared
// memory for the whole group.  The kv loop lives inside the block (Hopper
// blocks run in no order; the TPU grid's sequential kv axis becomes this
// loop).  Thread (ty, tx) = (tid / 8, tid % 8) owns rows 4*ty .. 4*ty+3,
// the keys tx + 8 j of each tile's score matrix and the columns tx + 8 c
// of the output; a row's max and sum reduce over its 8 threads, which are
// 8 neighbouring lanes of one warp.  Tiles masked for every row of the
// block are skipped when every row sees at least one real key (such a
// tile changes no bit of the result).  A row that sees no real key at all
// gets the reference's value: its online softmax takes p = 1 on every key,
// so acc is the sum of v, and l becomes the reference's padded key count.
// Ragged edges are masked in the kernel (zero-filled shared tiles), never
// padded in memory.  Products are plain f32 fused multiply-adds on the
// CUDA cores (__fmaf_rn; the library builds with -fmad=false); no library
// attention or matmul.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups x 8 lanes
constexpr float NEG = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p rounded to v's dtype (the reference's p.astype(v.dtype))
template <typename T>
__device__ __forceinline__ float round_like(float p);
template <>
__device__ __forceinline__ float round_like<float>(float p) { return p; }
template <>
__device__ __forceinline__ float round_like<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ float row_max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  return v;
}

__device__ __forceinline__ float row_sum8(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
  return v;
}

__device__ __forceinline__ bool unmasked(int qpos, int kpos, int Skv,
                                         int causal, int window) {
  return kpos < Skv && (!causal || qpos >= kpos) &&
         (!window || qpos - kpos <= window);
}

template <typename T, int HDMAX>
__global__ void __launch_bounds__(THREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, int S, int Skv, int H,
                      int KV, int hd, int causal, int window, int q_offset,
                      float scale, float ref_kv_count,
                      float* __restrict__ out) {
  constexpr int CPT = HDMAX / 8;  // output columns per thread
  extern __shared__ float smem[];
  const int ks = hd + 1;          // padded row stride of q/k tiles
  float* Qs = smem;               // BQ x ks
  float* Ks = Qs + BQ * ks;       // BK x ks
  float* Vs = Ks + BK * ks;       // BK x hd
  float* Ps = Vs + BK * hd;       // BQ x (BK + 1)

  const int G = H / KV;
  const int ppb = BQ / G;                      // positions per block
  const int p0 = blockIdx.x * ppb;             // first position
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y % KV;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const long qrow = (long)H * hd;              // q/out stride per position
  const long krow = (long)KV * hd;             // k/v stride per key

  // the q tile: row r = (position p0 + r / G, head kvh * G + r % G)
  for (int i = tid; i < BQ * hd; i += THREADS) {
    int r = i / hd, d = i % hd;
    int pos = p0 + r / G;
    float x = 0.f;
    if (pos < S)
      x = to_f32(q[((long)b * S + pos) * qrow + (long)(kvh * G + r % G) * hd
                   + d]);
    Qs[r * ks + d] = x;
  }

  // which kv tiles this block must visit
  const int n_tiles = (Skv + BK - 1) / BK;
  const int pos_hi = min(p0 + ppb, S) - 1;
  const int qmin = p0 + q_offset, qmax = pos_hi + q_offset;
  bool all_live = Skv > 0 && (!causal || qmin >= 0) &&
                  (!window || qmax - window <= Skv - 1);
  int t_lo = 0, t_hi = n_tiles - 1;
  if (all_live) {
    if (causal) t_hi = min(t_hi, qmax / BK);
    if (window) t_lo = max(0, (qmin - window) / BK);
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = p0 + (ty * 4 + i) / G + q_offset;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    for (int i = tid; i < BK * hd; i += THREADS) {
      int kk = i / hd, d = i % hd;
      int kpos = k0 + kk;
      float kx = 0.f, vx = 0.f;
      if (kpos < Skv) {
        long off = ((long)b * Skv + kpos) * krow + (long)kvh * hd + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[kk * ks + d] = kx;
      Vs[kk * hd + d] = vx;
    }
    __syncthreads();

    // scores: rows 4 ty + i, keys tx + 8 j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ks + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * ks + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int kpos = k0 + tx + 8 * j;
        s[i][j] = unmasked(qpos[i], kpos, Skv, causal, window)
                      ? __fmul_rn(s[i][j], scale)
                      : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      float m_new = fmaxf(m[i], row_max8(mx));
      alpha[i] = expf(__fsub_rn(m[i], m_new));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p = expf(__fsub_rn(s[i][j], m_new));
        ps = __fadd_rn(ps, p);
        // padded keys past Skv carry v = 0; p only matters for l there
        Ps[(ty * 4 + i) * (BK + 1) + tx + 8 * j] = round_like<T>(p);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), row_sum8(ps));
      m[i] = m_new;
    }
    __syncwarp();  // a row's p values come from its own warp's 8 lanes

    // acc = acc * alpha + p @ v, eight output columns at a time
#pragma unroll
    for (int c0 = 0; c0 < CPT; c0 += 8) {
      float pv[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) pv[i][c] = 0.f;
      for (int kk = 0; kk < BK; ++kk) {
        float pr[4], vv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          int col = tx + 8 * (c0 + c);
          vv[c] = col < hd ? Vs[kk * hd + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            pv[i][c] = __fmaf_rn(pr[i], vv[c], pv[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[i][c0 + c] =
              __fadd_rn(__fmul_rn(acc[i][c0 + c], alpha[i]), pv[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = ty * 4 + i;
    int pos = p0 + r / G;
    if (pos >= S) continue;
    float li = m[i] == NEG ? ref_kv_count : l[i];
    float den = fmaxf(li, 1e-30f);
    float* o = out + ((long)b * S + pos) * qrow + (long)(kvh * G + r % G) * hd;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      int col = tx + 8 * c;
      if (col < hd) o[col] = __fdiv_rn(acc[i][c], den);
    }
  }
}

template <typename T, int HDMAX>
int launch(const void* q, const void* k, const void* v, int B, int S,
           int Skv, int H, int KV, int hd, int causal, int window,
           int q_offset, float scale, float ref_kv_count, float* out,
           cudaStream_t stream) {
  size_t smem = sizeof(float) *
                ((size_t)BQ * (hd + 1) + (size_t)BK * (hd + 1) +
                 (size_t)BK * hd + (size_t)BQ * (BK + 1));
  auto kern = flash_attn_kernel<T, HDMAX>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int G = H / KV;
  dim3 grid((S + BQ / G - 1) / (BQ / G), B * KV);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, S, Skv, H, KV, hd, causal,
      window, q_offset, scale, ref_kv_count, out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, int B, int S,
             int Skv, int H, int KV, int hd, int causal, int window,
             int q_offset, float scale, float ref_kv_count, float* out,
             cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, B, S, Skv, H, KV, hd, causal, window,
                         q_offset, scale, ref_kv_count, out, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, B, S, Skv, H, KV, hd, causal, window,
                          q_offset, scale, ref_kv_count, out, stream);
  return launch<T, 256>(q, k, v, B, S, Skv, H, KV, hd, causal, window,
                        q_offset, scale, ref_kv_count, out, stream);
}

}  // namespace

extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 int B, int S, int Skv, int H, int KV, int hd,
                                 int causal, int window, int q_offset,
                                 float scale, int bf16, float* out,
                                 void* stream) {
  int bk = Skv < 128 ? Skv : 128;  // the reference's kv tile
  float ref_kv_count = bk > 0 ? (float)((Skv + bk - 1) / bk * bk) : 0.f;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, B, S, Skv, H, KV, hd, causal,
                                   window, q_offset, scale, ref_kv_count,
                                   out, st);
  return dispatch<float>(q, k, v, B, S, Skv, H, KV, hd, causal, window,
                         q_offset, scale, ref_kv_count, out, st);
}
