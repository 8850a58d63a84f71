// flash_attn_bwd: the gradient of GQA attention (kernel G's backward).
//
// The Pallas TPU kernel repro/kernels/flash_attn.py:flash_attention has no
// backward: the reference differentiates XLA's attention.  The port runs
// kernel G where XLA's attention was, so training on the card needs G's
// gradient; this computes the gradient the reference's train step takes.
// q (B, S, H, hd), k/v (B, Skv, KV, hd) in f32 or bf16, G = H / KV query
// heads per kv head; the forward's f32 output out (B, S, H, hd), its rows'
// log-sum-exp lse = m + log(l) (B, S, H) and dout (B, S, H, hd) f32 ->
// dq (B, S, H, hd), dk, dv (B, Skv, KV, hd), all f32.  With the forward's
// masks (causal: qpos >= kpos; window: qpos - kpos <= window; kpos < Skv;
// qpos = position + q_offset), s = q.k * scale, p = exp(s - lse) on
// unmasked pairs and 0 elsewhere, D = rowsum(dout * out):
//   dv = p^T dout,  dp = dout v^T,  ds = p * (dp - D),
//   dk = ds^T q * scale,  dq = ds k * scale.
// The forward's rounding of p to v's dtype is taken as the identity.  A
// row that sees no key gets zero gradients (p = 0 on every pair).  This
// differs from jax.vjp of the reference's ref.flash_attention_ref, whose
// -1e30 mask gives such a row a uniform p over the keys and so a nonzero
// dv there; no training path has such rows (every causal row sees its own
// position, and a window or q_offset never hides every key of a row).
//
// Bound on the H100: operations (the function needs 10 * hd flops per
// visible (row, key) pair: s, dp, dv, dk, dq; this kernel does 14 * hd, s
// and dp in both launches), against the bytes of q, k, v, out, dout, lse
// and the three outputs.  These SIMT kernels read two shared-memory
// operands per FMA pair, so shared memory bounds them well below the
// f32 peak; a tensor-core backward is later work.
//
// Design: two launches, no float atomics, so the result is deterministic.
// A query row is (position, head of the kv group), flattened as
// row = position * G + g, so a tile of rows may hold any G.  Everything
// runs on the CUDA cores in f32 (bf16 inputs widened as they are staged),
// 256 threads as 16 x 16: thread (ty, tx).
// 1. dq_kernel: one block per (BQ rows, batch x kv head).  It stages its q
//    and dout rows, forms D for them (written for launch 2) and walks the
//    kv tiles its rows can see (the forward's tile range), each staged as
//    f32: scores and dp (rows ty + 16 i, keys tx + 16 j), ds into shared
//    memory, then dq += ds k on rows ty + 16 i, columns tx + 16 c.
// 2. dkdv_kernel: one block per (BKV keys, batch x kv head).  It stages its
//    k and v once, walks the query rows that can see them (all G heads of
//    each position: the group's sum is formed in-block), forms p and ds
//    into shared memory and accumulates dv += p^T dout and dk += ds^T q on
//    keys ty + 16 i, columns tx + 16 c.
// Tiles: BQ = BKV = 64 rows / keys up to hd 128, 32 at hd 256, so the
// accumulators stay in registers (at most 64 a thread) and the staged
// tiles under 227 KB.  Shared rows are padded to hd + 1 floats against
// bank conflicts.  No library attention or matmul.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

template <int HD>
struct Shape {
  static constexpr int BQ = HD == 256 ? 32 : 64;   // query rows per tile
  static constexpr int BKV = HD == 256 ? 32 : 64;  // keys per tile
  static constexpr int RI = BQ / 16;               // rows a thread scores
  static constexpr int KJ = BKV / 16;              // keys a thread scores
  static constexpr int CC = HD / 16;               // columns a thread owns
  static constexpr int LD = HD + 1;                // padded row of a tile
  static constexpr int PL = BKV + 1;               // padded row of p / ds
  // q, dout, k, v tiles, then p and ds, then lse and D of the rows
  static constexpr int FLOATS =
      2 * BQ * LD + 2 * BKV * LD + 2 * BQ * PL + 2 * BQ;
  static constexpr int BYTES = FLOATS * 4;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ bool unmasked(int qpos, int kpos, int Skv,
                                         int causal, int window) {
  return kpos < Skv && (!causal || qpos >= kpos) &&
         (!window || qpos - kpos <= window);
}

// rows [r0, r0 + n) of (B, S, H, hd) for batch b, kv head kvh as f32 tile
// rows of stride ld_ (rows past n_rows are zero): a warp per row, its lanes
// on consecutive columns, so a row's address is formed once and every
// read is coalesced
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0,
                                           int n, int n_rows, int G, int H,
                                           int kvh, int S, int b, int hd,
                                           int ld_) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += THREADS / 32) {
    const int row = r0 + r;
    float* d = dst + r * ld_;
    if (row < n_rows) {
      const T* s = src + (((long)b * S + row / G) * H + kvh * G + row % G) *
                             hd;
      for (int c = lane; c < hd; c += 32) d[c] = ld(s + c);
    } else {
      for (int c = lane; c < hd; c += 32) d[c] = 0.f;
    }
  }
}

// keys [k0, k0 + n) of (B, Skv, KV, hd) for batch b, kv head kvh (keys past
// Skv are zero), a warp per key
template <typename T>
__device__ __forceinline__ void stage_keys(float* dst, const T* src, int k0,
                                           int n, int Skv, int KV, int kvh,
                                           int b, int hd, int ld_) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int kk = warp; kk < n; kk += THREADS / 32) {
    const int kpos = k0 + kk;
    float* d = dst + kk * ld_;
    if (kpos < Skv) {
      const T* s = src + (((long)b * Skv + kpos) * KV + kvh) * hd;
      for (int c = lane; c < hd; c += 32) d[c] = ld(s + c);
    } else {
      for (int c = lane; c < hd; c += 32) d[c] = 0.f;
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ out,
              const float* __restrict__ dout, const float* __restrict__ lse,
              int S, int Skv, int H, int KV, int hd, int causal, int window,
              int q_offset, float scale, float* __restrict__ dq,
              float* __restrict__ dbuf) {
  using L = Shape<HD>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + L::BQ * L::LD;   // dout rows
  float* Ks = Os + L::BQ * L::LD;
  float* Vs = Ks + L::BKV * L::LD;
  float* Ds = Vs + L::BKV * L::LD;  // ds of the tile
  float* Ls = Ds + 2 * L::BQ * L::PL;
  float* Dr = Ls + L::BQ;

  const int G = H / KV;
  const int n_rows = S * G;
  const int r0 = blockIdx.x * L::BQ;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  stage_rows(Qs, q, r0, L::BQ, n_rows, G, H, kvh, S, b, hd, L::LD);
  stage_rows(Os, dout, r0, L::BQ, n_rows, G, H, kvh, S, b, hd, L::LD);
  // lse and D = rowsum(dout * out) of each row, D also kept for launch 2
  for (int r = tid; r < L::BQ; r += THREADS) {
    const int row = r0 + r;
    float l = 0.f, dsum = 0.f;
    if (row < n_rows) {
      const long off = ((long)b * S + row / G) * H + kvh * G + row % G;
      l = lse[off];
      const float* o = out + off * hd;
      const float* g = dout + off * hd;
      for (int d = 0; d < hd; ++d) dsum = __fmaf_rn(g[d], o[d], dsum);
      dbuf[off] = dsum;
    }
    Ls[r] = l;
    Dr[r] = dsum;
  }

  // the keys the block's rows can see (the forward's tile range)
  const int row_hi = min(r0 + L::BQ, n_rows) - 1;
  const int qmin = r0 / G + q_offset, qmax = row_hi / G + q_offset;
  int k_lo = 0, k_hi = Skv - 1;
  if (window) k_lo = max(0, qmin - window);
  if (causal) k_hi = min(k_hi, qmax);

  float acc[L::RI][L::CC];
#pragma unroll
  for (int i = 0; i < L::RI; ++i)
#pragma unroll
    for (int c = 0; c < L::CC; ++c) acc[i][c] = 0.f;
  int qpos[L::RI];
#pragma unroll
  for (int i = 0; i < L::RI; ++i) qpos[i] = (r0 + ty + 16 * i) / G + q_offset;

  for (int k0 = k_lo / L::BKV * L::BKV; k0 <= k_hi; k0 += L::BKV) {
    __syncthreads();  // the previous tile's k, v and ds are consumed
    stage_keys(Ks, k, k0, L::BKV, Skv, KV, kvh, b, hd, L::LD);
    stage_keys(Vs, v, k0, L::BKV, Skv, KV, kvh, b, hd, L::LD);
    __syncthreads();

    float s[L::RI][L::KJ], dp[L::RI][L::KJ];
#pragma unroll
    for (int i = 0; i < L::RI; ++i)
#pragma unroll
      for (int j = 0; j < L::KJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[L::RI], gv[L::RI];
#pragma unroll
      for (int i = 0; i < L::RI; ++i) {
        qv[i] = Qs[(ty + 16 * i) * L::LD + d];
        gv[i] = Os[(ty + 16 * i) * L::LD + d];
      }
#pragma unroll
      for (int j = 0; j < L::KJ; ++j) {
        const float kx = Ks[(tx + 16 * j) * L::LD + d];
        const float vx = Vs[(tx + 16 * j) * L::LD + d];
#pragma unroll
        for (int i = 0; i < L::RI; ++i) {
          s[i][j] = __fmaf_rn(qv[i], kx, s[i][j]);
          dp[i][j] = __fmaf_rn(gv[i], vx, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < L::RI; ++i) {
      const int r = ty + 16 * i;
      const bool live = r0 + r < n_rows;
#pragma unroll
      for (int j = 0; j < L::KJ; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (live && unmasked(qpos[i], k0 + c, Skv, causal, window)) {
          const float p = expf(__fsub_rn(__fmul_rn(s[i][j], scale), Ls[r]));
          ds = __fmul_rn(p, __fsub_rn(dp[i][j], Dr[r]));
        }
        Ds[r * L::PL + c] = ds;
      }
    }
    __syncthreads();

    // dq += ds k: rows ty + 16 i, columns tx + 16 c
    for (int c = 0; c < L::BKV; ++c) {
      float dsv[L::RI];
#pragma unroll
      for (int i = 0; i < L::RI; ++i) dsv[i] = Ds[(ty + 16 * i) * L::PL + c];
#pragma unroll
      for (int cc = 0; cc < L::CC; ++cc) {
        const float kx = Ks[c * L::LD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < L::RI; ++i)
          acc[i][cc] = __fmaf_rn(dsv[i], kx, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < L::RI; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n_rows) continue;
    float* o = dq + (((long)b * S + row / G) * H + kvh * G + row % G) * hd;
#pragma unroll
    for (int cc = 0; cc < L::CC; ++cc) {
      const int col = tx + 16 * cc;
      if (col < hd) o[col] = __fmul_rn(acc[i][cc], scale);
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ dbuf, int S, int Skv, int H,
                int KV, int hd, int causal, int window, int q_offset,
                float scale, float* __restrict__ dk,
                float* __restrict__ dv) {
  using L = Shape<HD>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + L::BQ * L::LD;   // dout rows
  float* Ks = Os + L::BQ * L::LD;
  float* Vs = Ks + L::BKV * L::LD;
  float* Ps = Vs + L::BKV * L::LD;  // p of the tile
  float* Ds = Ps + L::BQ * L::PL;   // ds of the tile
  float* Ls = Ds + L::BQ * L::PL;
  float* Dr = Ls + L::BQ;

  const int G = H / KV;
  const int n_rows = S * G;
  const int k0 = blockIdx.x * L::BKV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  stage_keys(Ks, k, k0, L::BKV, Skv, KV, kvh, b, hd, L::LD);
  stage_keys(Vs, v, k0, L::BKV, Skv, KV, kvh, b, hd, L::LD);

  // the positions that can see a key of the tile
  const int k_hi = min(k0 + L::BKV, Skv) - 1;
  int p_lo = 0, p_hi = S - 1;
  if (causal) p_lo = max(p_lo, k0 - q_offset);
  if (window) p_hi = min(p_hi, k_hi + window - q_offset);

  float ak[L::KJ][L::CC], av[L::KJ][L::CC];
#pragma unroll
  for (int i = 0; i < L::KJ; ++i)
#pragma unroll
    for (int c = 0; c < L::CC; ++c) ak[i][c] = av[i][c] = 0.f;

  const int row_end = (p_hi + 1) * G;
  for (int r0 = p_lo * G; r0 < row_end; r0 += L::BQ) {
    __syncthreads();  // the previous rows, p and ds are consumed
    stage_rows(Qs, q, r0, L::BQ, row_end, G, H, kvh, S, b, hd, L::LD);
    stage_rows(Os, dout, r0, L::BQ, row_end, G, H, kvh, S, b, hd, L::LD);
    for (int r = tid; r < L::BQ; r += THREADS) {
      const int row = r0 + r;
      float l = 0.f, dsum = 0.f;
      if (row < row_end) {
        const long off = ((long)b * S + row / G) * H + kvh * G + row % G;
        l = lse[off];
        dsum = dbuf[off];
      }
      Ls[r] = l;
      Dr[r] = dsum;
    }
    __syncthreads();

    float s[L::RI][L::KJ], dp[L::RI][L::KJ];
#pragma unroll
    for (int i = 0; i < L::RI; ++i)
#pragma unroll
      for (int j = 0; j < L::KJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[L::RI], gv[L::RI];
#pragma unroll
      for (int i = 0; i < L::RI; ++i) {
        qv[i] = Qs[(ty + 16 * i) * L::LD + d];
        gv[i] = Os[(ty + 16 * i) * L::LD + d];
      }
#pragma unroll
      for (int j = 0; j < L::KJ; ++j) {
        const float kx = Ks[(tx + 16 * j) * L::LD + d];
        const float vx = Vs[(tx + 16 * j) * L::LD + d];
#pragma unroll
        for (int i = 0; i < L::RI; ++i) {
          s[i][j] = __fmaf_rn(qv[i], kx, s[i][j]);
          dp[i][j] = __fmaf_rn(gv[i], vx, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < L::RI; ++i) {
      const int r = ty + 16 * i;
      const int row = r0 + r;
      const int qpos = row / G + q_offset;
#pragma unroll
      for (int j = 0; j < L::KJ; ++j) {
        const int c = tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (row < row_end && unmasked(qpos, k0 + c, Skv, causal, window)) {
          p = expf(__fsub_rn(__fmul_rn(s[i][j], scale), Ls[r]));
          ds = __fmul_rn(p, __fsub_rn(dp[i][j], Dr[r]));
        }
        Ps[r * L::PL + c] = p;
        Ds[r * L::PL + c] = ds;
      }
    }
    __syncthreads();

    // dv += p^T dout, dk += ds^T q: keys ty + 16 i, columns tx + 16 c
    for (int r = 0; r < L::BQ; ++r) {
      float pv[L::KJ], dsv[L::KJ];
#pragma unroll
      for (int i = 0; i < L::KJ; ++i) {
        pv[i] = Ps[r * L::PL + ty + 16 * i];
        dsv[i] = Ds[r * L::PL + ty + 16 * i];
      }
#pragma unroll
      for (int cc = 0; cc < L::CC; ++cc) {
        const float gx = Os[r * L::LD + tx + 16 * cc];
        const float qx = Qs[r * L::LD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < L::KJ; ++i) {
          av[i][cc] = __fmaf_rn(pv[i], gx, av[i][cc]);
          ak[i][cc] = __fmaf_rn(dsv[i], qx, ak[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < L::KJ; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Skv) continue;
    const long off = (((long)b * Skv + kpos) * KV + kvh) * hd;
#pragma unroll
    for (int cc = 0; cc < L::CC; ++cc) {
      const int col = tx + 16 * cc;
      if (col < hd) {
        dk[off + col] = __fmul_rn(ak[i][cc], scale);
        dv[off + col] = av[i][cc];
      }
    }
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, const float* out,
           const float* dout, const float* lse, int B, int S, int Skv, int H,
           int KV, int hd, int causal, int window, int q_offset, float scale,
           float* dq, float* dk, float* dv, float* dbuf,
           cudaStream_t stream) {
  using L = Shape<HD>;
  auto k1 = dq_kernel<HD, T>;
  auto k2 = dkdv_kernel<HD, T>;
  static const int e1 = (int)cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  static const int e2 = (int)cudaFuncSetAttribute(
      k2, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e1) return e1;
  if (e2) return e2;
  const long rows = (long)S * (H / KV);
  const long g1 = (rows + L::BQ - 1) / L::BQ;
  const long g2 = ((long)Skv + L::BKV - 1) / L::BKV;
  if (g1 > 0x7fffffff || g2 > 0x7fffffff || (long)B * KV > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (g1 > 0) {
    k1<<<dim3((unsigned)g1, B * KV), THREADS, L::BYTES, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, out, dout, lse, S, Skv, H, KV,
        hd, causal, window, q_offset, scale, dq, dbuf);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (g2 > 0) {
    k2<<<dim3((unsigned)g2, B * KV), THREADS, L::BYTES, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, dout, lse, dbuf, S, Skv, H,
        KV, hd, causal, window, q_offset, scale, dk, dv);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const float* out,
              const float* dout, const float* lse, int B, int S, int Skv,
              int H, int KV, int hd, int causal, int window, int q_offset,
              float scale, float* dq, float* dk, float* dv, float* dbuf,
              cudaStream_t st) {
  if (hd <= 64)
    return launch<64, T>(q, k, v, out, dout, lse, B, S, Skv, H, KV, hd,
                         causal, window, q_offset, scale, dq, dk, dv, dbuf,
                         st);
  if (hd <= 128)
    return launch<128, T>(q, k, v, out, dout, lse, B, S, Skv, H, KV, hd,
                          causal, window, q_offset, scale, dq, dk, dv, dbuf,
                          st);
  return launch<256, T>(q, k, v, out, dout, lse, B, S, Skv, H, KV, hd,
                        causal, window, q_offset, scale, dq, dk, dv, dbuf,
                        st);
}

}  // namespace

// q, k, v of one dtype (bf16 != 0: bfloat16, else f32), hd <= 256; out,
// dout and lse f32 as the forward gave them; dq, dk, dv f32 outputs and
// dbuf (B, S, H) f32 scratch for D.  The wrapper checks shapes first.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const float* out,
                                     const float* dout, const float* lse,
                                     int B, int S, int Skv, int H, int KV,
                                     int hd, int causal, int window,
                                     int q_offset, float scale, int bf16,
                                     float* dq, float* dk, float* dv,
                                     float* dbuf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, dout, lse, B, S, Skv, H,
                                    KV, hd, causal, window, q_offset, scale,
                                    dq, dk, dv, dbuf, st);
  return launch_hd<float>(q, k, v, out, dout, lse, B, S, Skv, H, KV, hd,
                          causal, window, q_offset, scale, dq, dk, dv, dbuf,
                          st);
}
