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
// row that sees no key (lse == -1e30: causal positions before key 0,
// window positions past the last key) took the forward's mean of the Skv
// keys over n, Skv rounded up to the reference's 128-key tile: it adds
// dout / n to dv at each of the Skv keys (p = 1 / n for dv alone) and
// keeps ds = 0, so dq and dk do not move.  Where n == Skv that is jax.vjp
// of the reference's ref.flash_attention_ref, whose -1e30 mask gives such
// a row a uniform p.  The dk/dv launches own their keys, so each adds the
// dead rows' share to its dv accumulators after its tiles (add_dead_rows,
// from f32 dout); the tile loops never meet a dead row.  Only a call whose
// masks leave such rows launches the dk/dv instance with that epilogue
// (DEAD = true): the other keeps the tile loop's code as it was (the
// epilogue's mere presence cost the bf16 hd-64 instance 26 %).
//
// Bound on the H100: operations (the function needs 10 * hd flops per
// visible (row, key) pair: s, dp, dv, dk, dq; both instances do 14 * hd,
// s and dp in both launches), against the bytes of q, k, v, out, dout,
// lse and the three outputs.
//
// Both instances: two launches, no float atomics, so the result is
// deterministic (two calls give the same bits).  A query row is (position,
// head of the kv group), flattened as row = position * G + g, so a tile of
// rows may hold any G <= 64.  The dtype picks the instance (no fallback
// from one to the other):
//
// * bf16: dq_tc_kernel and dkdv_tc_kernel, on the tensor cores.  Every
//   product is a wgmma (m64n64k16, bf16 operands, f32 accumulators):
//   S = Q K^T, dP = dO V^T, dQ += dS K in the first; S^T = K Q^T, dP^T =
//   V dO^T, dV += P^T dO, dK += dS^T Q in the second.  Tiles reach shared
//   memory as bf16 by 4-D TMA boxes with 128-byte swizzle (wgmma.cuh),
//   completion on mbarriers, issued by one thread, two stages: the load of
//   tile t + 2 runs while tile t + 1 is computed.  S and dP take both
//   operands K-major from shared memory; P and dS are rounded to bf16 in
//   registers as the A fragments of the accumulating products, whose B
//   (the k tile for dQ, the dout and q tiles for dV and dK) is read
//   MN-major from the same tiles.  The head dim is padded to 64, 128 or
//   256 by the TMA's zero fill.
//   1. dq_tc_kernel: one block per (ROWS rows = P = ROWS / G whole
//      positions x G heads, batch x kv head); one warpgroup per 64 rows,
//      two per block (one at hd 256, where two would need 256 KB of
//      tiles).  q arrives by one TMA box; dout arrives as f32, which the
//      block reads once: it forms D = rowsum(dout * out), rounds dout to
//      bf16 into its shared tile (swizzled as TMA would) and into the
//      scratch dob (B, S, H, hd) bf16 that the second launch TMA-loads,
//      and writes D to dbuf.  It then walks the key tiles its rows see
//      (k and v through the ring), the last positions first.
//   2. dkdv_tc_kernel: one block per (64 keys, batch x kv head), two
//      warpgroups that split the work of a tile: the first forms S^T, p
//      (into shared memory, f32) and dV += P^T dO, the second dP^T, then
//      (after a barrier) dS^T = P^T (dP^T - D) and dK += dS^T Q.  Each
//      warpgroup keeps one 64 x hd accumulator (128 f32 registers a thread
//      at hd 256, where one warpgroup could not hold both).  The block
//      walks the row tiles of P = 64 / G positions that see its keys, q
//      and dout (the bf16 copy) through the ring, the rows' lse and D read
//      from device memory.
//   The rows past P * G of a row tile are padding: zero-filled in shared
//   memory once (the TMA boxes hold only the P * G live rows), masked
//   (p = 0), never stored.
// * f32: dq_kernel and dkdv_kernel, SIMT (the CUDA cores): bf16 is the
//   only dtype the assigned configs train in.  256 threads as 16 x 16:
//   thread (ty, tx).
//   1. dq_kernel: one block per (BQ rows, batch x kv head).  It stages its
//      q and dout rows, forms D for them (written for launch 2) and walks
//      the kv tiles its rows can see (the forward's tile range), each
//      staged as f32: scores and dp (rows ty + 16 i, keys tx + 16 j), ds
//      into shared memory, then dq += ds k on rows ty + 16 i, columns
//      tx + 16 c.
//   2. dkdv_kernel: one block per (BKV keys, batch x kv head).  It stages
//      its k and v once, walks the query rows that can see them (all G
//      heads of each position: the group's sum is formed in-block), forms
//      p and ds into shared memory and accumulates dv += p^T dout and
//      dk += ds^T q on keys ty + 16 i, columns tx + 16 c.
//   Tiles: BQ = BKV = 64 rows / keys up to hd 128, 32 at hd 256, so the
//   accumulators stay in registers (at most 64 a thread) and the staged
//   tiles under 227 KB.  Shared rows are padded to hd + 1 floats against
//   bank conflicts.  Shared memory bounds these kernels (two operands
//   read per FMA pair), well below the f32 peak.
// No library attention or matmul.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "wgmma.cuh"

namespace {

// --------------------------------------------------------------------------
// f32: SIMT kernels
// --------------------------------------------------------------------------

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

__device__ __forceinline__ bool unmasked(int qpos, int kpos, int Skv,
                                         int causal, int window) {
  return kpos < Skv && (!causal || qpos >= kpos) &&
         (!window || qpos - kpos <= window);
}

// The positions whose rows see no key: [0, pre) (causal positions before
// key 0) and [suf, S) (window positions past the last key); every other
// row sees a key (kernels/flash_attn.py:dead_positions).
__host__ __device__ __forceinline__ int2 dead_positions(int S, int Skv,
                                                        int causal,
                                                        int window,
                                                        int q_offset) {
  // pre = min(S, max(0, -q_offset)), suf = max(pre, min(S, Skv + window -
  // q_offset)), in ternaries (the host computes it too)
  const int pre = !causal || q_offset >= 0 ? 0 : -q_offset < S ? -q_offset
                                                                : S;
  const int end = Skv + window - q_offset < S ? Skv + window - q_offset : S;
  return make_int2(pre, !window ? S : end > pre ? end : pre);
}

// acc[a][e] (a dv accumulator of the thread, of column col(a, e); none
// past hd) += dout / n of every row of kv head kvh that sees no key (lse
// == NEG), the rows in ascending order
template <int NA, int NE, class Col>
__device__ __forceinline__ void add_dead_rows(
    float (&acc)[NA][NE], Col col, const float* __restrict__ lse,
    const float* __restrict__ dout, int S, int Skv, int H, int G, int kvh,
    int b, int hd, int causal, int window, int q_offset, float inv_n) {
  const int2 dead = dead_positions(S, Skv, causal, window, q_offset);
  for (int pos = dead.x > 0 ? 0 : dead.y; pos < S;
       pos = pos + 1 == dead.x ? dead.y : pos + 1) {
    for (int g = 0; g < G; ++g) {
      const long off = ((long)b * S + pos) * H + kvh * G + g;
      if (lse[off] != NEG) continue;
      const float* d = dout + off * hd;
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const int c = col(a, e);
          if (c < hd)
            acc[a][e] = __fadd_rn(acc[a][e], __fmul_rn(d[c], inv_n));
        }
    }
  }
}

// the dv accumulators' columns: SIMT av[i][cc] (keys ty + 16 i) holds
// column tx + 16 cc; the wgmma accumulator acc[c][e] (keys r0, r0 + 8)
// column 64 c + 8 (e / 4) + cq + (e & 1)
struct SimtCol {
  int tx;
  __device__ int operator()(int, int cc) const { return tx + 16 * cc; }
};
struct WgmmaCol {
  int cq;
  __device__ int operator()(int c, int e) const {
    return c * 64 + 8 * (e >> 2) + cq + (e & 1);
  }
};

// rows [r0, r0 + n) of (B, S, H, hd) for batch b, kv head kvh as f32 tile
// rows of stride ld_ (rows past n_rows are zero): a warp per row, its lanes
// on consecutive columns, so a row's address is formed once and every
// read is coalesced
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int n, int n_rows, int G,
                                           int H, int kvh, int S, int b,
                                           int hd, int ld_) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += THREADS / 32) {
    const int row = r0 + r;
    float* d = dst + r * ld_;
    if (row < n_rows) {
      const float* s =
          src + (((long)b * S + row / G) * H + kvh * G + row % G) * hd;
      for (int c = lane; c < hd; c += 32) d[c] = s[c];
    } else {
      for (int c = lane; c < hd; c += 32) d[c] = 0.f;
    }
  }
}

// keys [k0, k0 + n) of (B, Skv, KV, hd) for batch b, kv head kvh (keys past
// Skv are zero), a warp per key
__device__ __forceinline__ void stage_keys(float* dst, const float* src,
                                           int k0, int n, int Skv, int KV,
                                           int kvh, int b, int hd, int ld_) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int kk = warp; kk < n; kk += THREADS / 32) {
    const int kpos = k0 + kk;
    float* d = dst + kk * ld_;
    if (kpos < Skv) {
      const float* s = src + (((long)b * Skv + kpos) * KV + kvh) * hd;
      for (int c = lane; c < hd; c += 32) d[c] = s[c];
    } else {
      for (int c = lane; c < hd; c += 32) d[c] = 0.f;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ out,
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

template <int HD, bool DEAD>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ dbuf, int S, int Skv, int H,
                int KV, int hd, int causal, int window, int q_offset,
                float scale, float inv_n, float* __restrict__ dk,
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
  if constexpr (DEAD)
    add_dead_rows(av, SimtCol{tx}, lse, dout, S, Skv, H, G, kvh, b, hd,
                  causal, window, q_offset, inv_n);

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

template <class K>
int max_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v,
                const float* out, const float* dout, const float* lse, int B,
                int S, int Skv, int H, int KV, int hd, int causal, int window,
                int q_offset, float scale, float inv_n, int dead, float* dq,
                float* dk, float* dv, float* dbuf, cudaStream_t stream) {
  using L = Shape<HD>;
  auto k1 = dq_kernel<HD>;
  auto k2 = dead ? dkdv_kernel<HD, true> : dkdv_kernel<HD, false>;
  static const int e1 = max_smem(k1, L::BYTES);
  static const int e2 = max_smem(dkdv_kernel<HD, false>, L::BYTES);
  static const int e3 = max_smem(dkdv_kernel<HD, true>, L::BYTES);
  if (e1) return e1;
  if (e2) return e2;
  if (e3) return e3;
  const long rows = (long)S * (H / KV);
  const long g1 = (rows + L::BQ - 1) / L::BQ;
  const long g2 = ((long)Skv + L::BKV - 1) / L::BKV;
  if (g1 > 0x7fffffff || g2 > 0x7fffffff || (long)B * KV > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (g1 > 0) {
    k1<<<dim3((unsigned)g1, B * KV), THREADS, L::BYTES, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, out, dout, lse, S,
        Skv, H, KV, hd, causal, window, q_offset, scale, dq, dbuf);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (g2 > 0) {
    k2<<<dim3((unsigned)g2, B * KV), THREADS, L::BYTES, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, dout, lse, dbuf,
        S, Skv, H, KV, hd, causal, window, q_offset, scale, inv_n, dk, dv);
  }
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// bf16: tensor-core kernels (TMA, mbarriers, wgmma)
// --------------------------------------------------------------------------

using acopy::mbar_expect_tx;
using acopy::mbar_init;
using acopy::mbar_wait;
using acopy::smem_u32;
using tc::ROW_BYTES;

constexpr int TK = 64;  // keys per tile, and rows of a dk/dv row tile

// The dq kernel's block for a padded head dim: NWG warpgroups of 64 rows,
// and its shared memory, each part 1,024-byte aligned: q and dout as HDP/64
// blocks of [ROWS rows][64 columns] bf16, two stages of k and of v, each
// HDP/64 blocks of [64 keys][64 columns], then D of the rows, then the
// mbarriers.
template <int HDP>
struct DqShape {
  static constexpr int NB = HDP / 64;
  static constexpr int NWG = HDP == 256 ? 1 : 2;
  static constexpr int ROWS = 64 * NWG;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int Q_BYTES = ROWS * HDP * 2;
  static constexpr int T_BYTES = TK * HDP * 2;
  static constexpr int D_OFF = 2 * Q_BYTES + 4 * T_BYTES;
  static constexpr int BAR_OFF = D_OFF + ROWS * 4;
  static constexpr int BYTES = BAR_OFF + 64 + 1024;  // + alignment slack
};

// The dk/dv kernel's block: two warpgroups on 64 keys; k and v as HDP/64
// blocks of [64 keys][64 columns], two stages of a q and a dout tile of 64
// rows each, then p of a tile (64 x 64 f32, in the accumulator layout),
// then the mbarriers.
template <int HDP>
struct KvShape {
  static constexpr int NB = HDP / 64;
  static constexpr int THREADS = 256;
  static constexpr int T_BYTES = TK * HDP * 2;
  static constexpr int P_OFF = 6 * T_BYTES;
  static constexpr int BAR_OFF = P_OFF + 64 * 64 * 4;
  static constexpr int BYTES = BAR_OFF + 64 + 1024;
};

// byte offset of columns d, d + 1 (d even) of row r in a tile of ``rows``
// rows per 64-column block, swizzled as TMA writes it
__device__ __forceinline__ int swz(int rows, int r, int d) {
  return (d >> 6) * rows * ROW_BYTES + r * ROW_BYTES +
         ((((d & 63) >> 3) ^ (r & 7)) << 4) + (d & 7) * 2;
}

// descriptor of k16 step kk of a K-major operand: 64 rows from row0 of a
// tile of ``rows`` rows per column block, its columns along K
__device__ __forceinline__ uint64_t kdesc(const uint8_t* t, int rows,
                                          int row0, int kk) {
  return tc::gmma_desc(t + (kk >> 2) * rows * ROW_BYTES + row0 * ROW_BYTES +
                           (kk & 3) * 32,
                       16, 1024);
}

// descriptor of k16 step kc of an MN-major operand: rows 16 kc .. 16 kc +
// 15 of a tile of ``rows`` rows per column block (its rows along K),
// column block c
__device__ __forceinline__ uint64_t ndesc(const uint8_t* t, int rows, int c,
                                          int kc) {
  return tc::gmma_desc(t + c * rows * ROW_BYTES + kc * 16 * ROW_BYTES,
                       rows * ROW_BYTES, 1024);
}

// zero rows [live, rows) of every column block of a tile (the TMA boxes
// write only the live rows), then make the writes visible to wgmma's reads
__device__ __forceinline__ void zero_rows(uint8_t* t, int rows, int live,
                                          int nb, int tid, int nthreads) {
  const int per = (rows - live) * (ROW_BYTES / 16);
  for (int i = tid; i < nb * per; i += nthreads) {
    const int c = i / per, rest = i % per;
    *reinterpret_cast<uint4*>(t + c * rows * ROW_BYTES +
                              (live + rest / (ROW_BYTES / 16)) * ROW_BYTES +
                              rest % (ROW_BYTES / 16) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][32]) {
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
}

// acc (64 rows x NB column blocks) += pa (64 x 64 in registers) * the
// MN-major tile t of ``rows`` rows per column block (its 64 rows along K).
// Every step is unrolled (a loop with a run-time bound around a wgmma
// makes ptxas serialise the products); padded columns add zeros.
template <int NB>
__device__ __forceinline__ void mma_acc(float (&acc)[NB][32],
                                        const uint32_t (&pa)[4][4],
                                        const uint8_t* t, int rows) {
  tc::wg_fence();
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      tc::mma_rs(acc[c], pa[kc], ndesc(t, rows, c, kc));
  tc::wg_commit();
  tc::wg_wait_all();
#pragma unroll
  for (int c = 0; c < NB; ++c) tc::fence_regs(acc[c]);
}

// rows r and r + 8 (element e & 2 selects) of a 64 x NB*64 accumulator,
// times f, into the row-major f32 rows o0 / o1 (null: not stored)
template <int NB>
__device__ __forceinline__ void store_rows(const float (&acc)[NB][32],
                                           float* o0, float* o1, int cq,
                                           int hd, float f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* o = h ? o1 : o0;
    if (o == nullptr) continue;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 64 + 8 * j + cq;
        if (col < hd)
          *reinterpret_cast<float2*>(o + col) =
              make_float2(__fmul_rn(acc[c][4 * j + 2 * h], f),
                          __fmul_rn(acc[c][4 * j + 2 * h + 1], f));
      }
  }
}

// key tile i of a dq block's range into stage i % 2: k and v
template <int NB>
__device__ __forceinline__ void load_kv(uint8_t* Ks, uint8_t* Vs, int t_bytes,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint64_t* bars,
                                        int i, int t_lo, int kvh, int b) {
  const int s = i & 1, k0 = (t_lo + i) * TK;
  mbar_expect_tx(&bars[1 + s], 2 * t_bytes);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    tc::tma_load(Ks + s * t_bytes + c * TK * ROW_BYTES, tk, &bars[1 + s],
                 c * 64, kvh, k0, b);
    tc::tma_load(Vs + s * t_bytes + c * TK * ROW_BYTES, tv, &bars[1 + s],
                 c * 64, kvh, k0, b);
  }
}

template <int HDP>
__global__ void __launch_bounds__(DqShape<HDP>::THREADS, 1)
    dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ out,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse, int S, int Skv, int H,
                 int KV, int hd, int causal, int window, int q_offset,
                 float scale, float* __restrict__ dq,
                 float* __restrict__ dbuf, __nv_bfloat16* __restrict__ dob) {
  using L = DqShape<HDP>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;
  uint8_t* Os = base + L::Q_BYTES;                 // dout, bf16
  uint8_t* Ks = base + 2 * L::Q_BYTES;             // stage s at s * T_BYTES
  uint8_t* Vs = Ks + 2 * L::T_BYTES;
  float* Drow = reinterpret_cast<float*>(base + L::D_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  // bars[0]: q; bars[1 + s]: stage s of (k, v)

  // one block per (row tile, batch x kv head), the last positions (the
  // longest under a causal mask) first
  const int G = H / KV;
  const int ppb = L::ROWS / G;
  const int live = ppb * G;  // rows past this are padding
  const int nbk = gridDim.x / ((S + ppb - 1) / ppb);  // B * KV
  const int lin = gridDim.x - 1 - blockIdx.x;
  const int p0 = lin / nbk * ppb;
  const int b = lin % nbk / KV;
  const int kvh = lin % nbk % KV;
  const int tid = threadIdx.x;

  // the key tiles the rows see
  const int qmin = p0 + q_offset, qmax = min(p0 + ppb, S) - 1 + q_offset;
  int k_lo = 0, k_hi = Skv - 1;
  if (window) k_lo = max(0, qmin - window);
  if (causal) k_hi = min(k_hi, qmax);
  const int t_lo = k_lo / TK;
  const int n = k_hi >= k_lo ? k_hi / TK - t_lo + 1 : 0;

  zero_rows(Qs, L::ROWS, live, NB, tid, L::THREADS);
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init(&bars[2], 1);
    acopy::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], NB * live * ROW_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tc::tma_load(Qs + c * L::ROWS * ROW_BYTES, &tq, &bars[0], c * 64,
                   kvh * G, p0, b);
    for (int i = 0; i < 2 && i < n; ++i)
      load_kv<NB>(Ks, Vs, L::T_BYTES, &tk, &tv, bars, i, t_lo, kvh, b);
  }

  // dout as bf16 into the shared tile (padding rows and columns past hd
  // zero) and into dob; D = rowsum(dout * out) in f32 into Drow and dbuf.
  // A warp per row, lane l on columns 2l, 2l + 1 of each column block.
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < L::ROWS; r += L::THREADS / 32) {
    const int pos = p0 + r / G;
    const bool ok = r < live && pos < S;
    const long row = ((long)b * S + pos) * H + kvh * G + r % G;
    float dsum = 0.f;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const int d = c * 64 + 2 * lane;
      float2 g = make_float2(0.f, 0.f), o = make_float2(0.f, 0.f);
      if (ok && d < hd) {
        g = *reinterpret_cast<const float2*>(dout + row * hd + d);
        o = *reinterpret_cast<const float2*>(out + row * hd + d);
      }
      dsum = __fmaf_rn(g.x, o.x, dsum);
      dsum = __fmaf_rn(g.y, o.y, dsum);
      const uint32_t pk = tc::pack_bf16(g.x, g.y);
      *reinterpret_cast<uint32_t*>(Os + swz(L::ROWS, r, d)) = pk;
      if (ok && d < hd)
        *reinterpret_cast<uint32_t*>(dob + row * hd + d) = pk;
    }
#pragma unroll
    for (int m = 16; m; m >>= 1)
      dsum = __fadd_rn(dsum, __shfl_xor_sync(0xffffffffu, dsum, m));
    if (lane == 0) {
      Drow[r] = dsum;
      if (ok) dbuf[row] = dsum;
    }
  }
  fence_async_smem();
  __syncthreads();

  // warpgroup wg on rows 64 wg ..; accumulator layout of a 64 x 64 wgmma
  // (wgmma.cuh:acc_to_a): rows r0 and r0 + 8, columns 8 (e / 4) + cq +
  // (e & 1)
  const int wg = tid >> 7;
  const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float lse_r[2], d_r[2];
  int qpos[2];
  bool rl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int pos = p0 + r / G;
    rl[h] = r < live && pos < S;
    qpos[h] = pos + q_offset;
    lse_r[h] = rl[h] ? lse[((long)b * S + pos) * H + kvh * G + r % G] : 0.f;
    d_r[h] = Drow[r];
  }
  float acc[NB][32];
  zero_acc<NB>(acc);

  mbar_wait(&bars[0], 0);
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    const int k0 = (t_lo + i) * TK;
    mbar_wait(&bars[1 + s], (i >> 1) & 1);
    const uint8_t* Kst = Ks + s * L::T_BYTES;
    const uint8_t* Vst = Vs + s * L::T_BYTES;

    // S = Q K^T and dP = dO V^T
    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {  // padded columns add zeros
      tc::mma_ss(sc, kdesc(Qs, L::ROWS, wg * 64, kk), kdesc(Kst, TK, 0, kk));
      tc::mma_ss(dp, kdesc(Os, L::ROWS, wg * 64, kk), kdesc(Vst, TK, 0, kk));
    }
    tc::wg_commit();
    tc::wg_wait_all();
    tc::fence_regs(sc);
    tc::fence_regs(dp);

    // ds = p (dp - D) with p = exp(s scale - lse) on unmasked pairs, else 0
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1;
      const int kpos = k0 + 8 * (e >> 2) + cq + (e & 1);
      float ds = 0.f;
      if (rl[h] && unmasked(qpos[h], kpos, Skv, causal, window)) {
        const float p = expf(__fsub_rn(__fmul_rn(sc[e], scale), lse_r[h]));
        ds = __fmul_rn(p, __fsub_rn(dp[e], d_r[h]));
      }
      sc[e] = ds;
    }
    uint32_t pa[4][4];
    tc::acc_to_a(sc, pa);
    // dQ += dS K, the k tile's keys along K
    mma_acc<NB>(acc, pa, Kst, TK);

    __syncthreads();  // every warpgroup is done with stage s
    if (tid == 0 && i + 2 < n)
      load_kv<NB>(Ks, Vs, L::T_BYTES, &tk, &tv, bars, i + 2, t_lo, kvh, b);
  }

  float* o[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    o[h] = rl[h] ? dq + (((long)b * S + p0 + r / G) * H + kvh * G + r % G) *
                            hd
                 : nullptr;
  }
  store_rows<NB>(acc, o[0], o[1], cq, hd, scale);
}

// row tile i of a dk/dv block's range (P positions from p_lo + i P) into
// stage i % 2: q and dout, each as one box of P positions x G heads
template <int NB>
__device__ __forceinline__ void load_rows(uint8_t* Rs, int t_bytes,
                                          const CUtensorMap* tq,
                                          const CUtensorMap* to,
                                          uint64_t* bars, int i, int p_lo,
                                          int ppb, int live, int G, int kvh,
                                          int b) {
  const int s = i & 1, pt = p_lo + i * ppb;
  mbar_expect_tx(&bars[1 + s], 2 * NB * live * ROW_BYTES);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    tc::tma_load(Rs + 2 * s * t_bytes + c * TK * ROW_BYTES, tq, &bars[1 + s],
                 c * 64, kvh * G, pt, b);
    tc::tma_load(Rs + (2 * s + 1) * t_bytes + c * TK * ROW_BYTES, to,
                 &bars[1 + s], c * 64, kvh * G, pt, b);
  }
}

template <int HDP, bool DEAD>
__global__ void __launch_bounds__(KvShape<HDP>::THREADS, 1)
    dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dbuf, int S, int Skv, int H,
                   int KV, int hd, int causal, int window, int q_offset,
                   float scale, float inv_n, float* __restrict__ dk,
                   float* __restrict__ dv) {
  using L = KvShape<HDP>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = base;
  uint8_t* Vs = base + L::T_BYTES;
  uint8_t* Rs = base + 2 * L::T_BYTES;  // stage s: q at 2 s, dout at 2 s + 1
  float* Px = reinterpret_cast<float*>(base + L::P_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  // bars[0]: k and v; bars[1 + s]: stage s of (q, dout)

  // one block per (key block, batch x kv head), the first key blocks (the
  // longest under a causal mask) first
  const int G = H / KV;
  const int ppb = TK / G;
  const int live = ppb * G;
  const int nkb = (Skv + TK - 1) / TK;
  const int bkv = gridDim.x / nkb;  // B * KV
  const int k0 = blockIdx.x / bkv * TK;
  const int b = blockIdx.x % bkv / KV;
  const int kvh = blockIdx.x % bkv % KV;
  const int tid = threadIdx.x;

  // the positions that see a key of the block, in tiles of ppb
  const int k_hi = min(k0 + TK, Skv) - 1;
  int p_lo = 0, p_hi = S - 1;
  if (causal) p_lo = max(0, k0 - q_offset);
  if (window) p_hi = min(p_hi, k_hi + window - q_offset);
  const int n = p_hi >= p_lo ? (p_hi - p_lo) / ppb + 1 : 0;

  for (int t = 0; t < 4; ++t)
    zero_rows(Rs + t * L::T_BYTES, TK, live, NB, tid, L::THREADS);
  fence_async_smem();
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init(&bars[2], 1);
    acopy::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * L::T_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tc::tma_load(Ks + c * TK * ROW_BYTES, &tk, &bars[0], c * 64, kvh, k0,
                   b);
      tc::tma_load(Vs + c * TK * ROW_BYTES, &tv, &bars[0], c * 64, kvh, k0,
                   b);
    }
    for (int i = 0; i < 2 && i < n; ++i)
      load_rows<NB>(Rs, L::T_BYTES, &tq, &to, bars, i, p_lo, ppb, live, G,
                    kvh, b);
  }

  // warpgroup 0: S^T = K Q^T, p, dV += P^T dO; warpgroup 1: dP^T = V dO^T,
  // dS^T = P^T (dP^T - D), dK += dS^T Q.  Accumulator layout: keys k0 + r0
  // and k0 + r0 + 8, row-tile columns 8 (e / 4) + cq + (e & 1).
  const int wg = tid >> 7, wt = tid & 127, lane = tid & 31;
  const int r0 = (wt >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const uint8_t* A64 = wg == 0 ? Ks : Vs;
  const long rbase = (long)b * S * H + kvh * G;  // (b, position 0, head kvh G)
  float acc[NB][32];
  zero_acc<NB>(acc);

  mbar_wait(&bars[0], 0);
  for (int i = 0; i < n; ++i) {
    const int s = i & 1, pt = p_lo + i * ppb;
    mbar_wait(&bars[1 + s], (i >> 1) & 1);
    const uint8_t* Qt = Rs + 2 * s * L::T_BYTES;
    const uint8_t* Ot = Qt + L::T_BYTES;

    float st[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = 0.f;
    tc::wg_fence();
    const uint8_t* Bk = wg == 0 ? Qt : Ot;
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)  // padded columns add zeros
      tc::mma_ss(st, kdesc(A64, TK, 0, kk), kdesc(Bk, TK, 0, kk));
    tc::wg_commit();
    tc::wg_wait_all();
    tc::fence_regs(st);

    // column c of the tile is row (position pt + c / G, head c % G)
    float dcol[16];  // warpgroup 1: D of the thread's 16 columns
    if (wg == 0) {
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = 8 * m + cq + u, cd = c / G, pos = pt + cd;
          const bool ok = c < live && pos < S;
          const float l =
              ok ? lse[rbase + (long)pos * H + (c - cd * G)] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 4 * m + 2 * h + u;
            float p = 0.f;
            if (ok && unmasked(pos + q_offset, k0 + r0 + 8 * h, Skv, causal,
                               window))
              p = expf(__fsub_rn(__fmul_rn(st[e], scale), l));
            st[e] = p;
            Px[e * 128 + wt] = p;
          }
        }
    } else {
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = 8 * m + cq + u, cd = c / G, pos = pt + cd;
          dcol[2 * m + u] = c < live && pos < S
                                ? dbuf[rbase + (long)pos * H + (c - cd * G)]
                                : 0.f;
        }
    }
    __syncthreads();  // p of the tile is in Px
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        st[e] = __fmul_rn(Px[e * 128 + wt],
                          __fsub_rn(st[e], dcol[2 * (e >> 2) + (e & 1)]));
    }
    uint32_t pa[4][4];
    tc::acc_to_a(st, pa);
    // dV += P^T dO or dK += dS^T Q, the row tile's rows along K
    mma_acc<NB>(acc, pa, wg == 0 ? Ot : Qt, TK);

    __syncthreads();  // both warpgroups are done with stage s and Px
    if (tid == 0 && i + 2 < n)
      load_rows<NB>(Rs, L::T_BYTES, &tq, &to, bars, i + 2, p_lo, ppb, live,
                    G, kvh, b);
  }

  if constexpr (DEAD) {
    if (wg == 0)  // dV
      add_dead_rows(acc, WgmmaCol{cq}, lse, dout, S, Skv, H, G, kvh, b, hd,
                    causal, window, q_offset, inv_n);
  }

  float* o[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + r0 + 8 * h;
    o[h] = key < Skv ? (wg == 0 ? dv : dk) +
                           (((long)b * Skv + key) * KV + kvh) * hd
                     : nullptr;
  }
  store_rows<NB>(acc, o[0], o[1], cq, hd, wg == 0 ? 1.f : scale);
}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, const float* out,
              const float* dout, const float* lse, int B, int S, int Skv,
              int H, int KV, int hd, int causal, int window, int q_offset,
              float scale, float inv_n, int dead, float* dq, float* dk,
              float* dv, float* dbuf, void* dob, cudaStream_t stream) {
  acopy::EncodeTiled fn = acopy::encoder();
  if (fn == nullptr) return acopy::ERR_NO_ENCODER;
  using A = DqShape<HDP>;
  using K = KvShape<HDP>;
  const int G = H / KV;
  CUtensorMap tq1, tq2, to, tk, tv;
  int err = tc::encode(fn, &tq1, q, hd, H, S, B, G, A::ROWS / G);
  if (!err) err = tc::encode(fn, &tq2, q, hd, H, S, B, G, TK / G);
  if (!err) err = tc::encode(fn, &to, dob, hd, H, S, B, G, TK / G);
  if (!err) err = tc::encode(fn, &tk, k, hd, KV, Skv, B, 1, TK);
  if (!err) err = tc::encode(fn, &tv, v, hd, KV, Skv, B, 1, TK);
  if (err) return err;
  auto k1 = dq_tc_kernel<HDP>;
  auto k2 = dead ? dkdv_tc_kernel<HDP, true> : dkdv_tc_kernel<HDP, false>;
  static const int e1 = max_smem(k1, A::BYTES);
  static const int e2 = max_smem(dkdv_tc_kernel<HDP, false>, K::BYTES);
  static const int e3 = max_smem(dkdv_tc_kernel<HDP, true>, K::BYTES);
  if (e1) return e1;
  if (e2) return e2;
  if (e3) return e3;
  const int ppb = A::ROWS / G;
  const long g1 = (long)((S + ppb - 1) / ppb) * B * KV;
  const long g2 = (long)((Skv + TK - 1) / TK) * B * KV;
  if (g1 > 0x7fffffff || g2 > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  if (g1 > 0) {
    k1<<<(unsigned)g1, A::THREADS, A::BYTES, stream>>>(
        tq1, tk, tv, out, dout, lse, S, Skv, H, KV, hd, causal, window,
        q_offset, scale, dq, dbuf, (__nv_bfloat16*)dob);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (g2 > 0)
    k2<<<(unsigned)g2, K::THREADS, K::BYTES, stream>>>(
        tq2, tk, tv, to, dout, lse, dbuf, S, Skv, H, KV, hd, causal, window,
        q_offset, scale, inv_n, dk, dv);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v of one dtype (bf16 != 0: bfloat16, else f32), hd <= 256 (a
// multiple of 8 in bf16, and q, k, v, dob 16-byte aligned: the TMA copies);
// out, dout and lse f32 as the forward gave them; dq, dk, dv f32 outputs,
// dbuf (B, S, H) f32 scratch for D and, in bf16, dob (B, S, H, hd) bf16
// scratch for dout (null in f32).  The wrapper checks shapes first.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const float* out,
                                     const float* dout, const float* lse,
                                     int B, int S, int Skv, int H, int KV,
                                     int hd, int causal, int window,
                                     int q_offset, float scale, int bf16,
                                     float* dq, float* dk, float* dv,
                                     float* dbuf, void* dob, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // a dead row's share of dv: 1 / n, n = Skv rounded up to the reference's
  // 128-key tile (the forward's ref_kv_count)
  const int bk = Skv < 128 ? Skv : 128;
  const float inv_n =
      bk > 0 ? 1.0f / (float)((Skv + bk - 1) / bk * bk) : 0.f;
  const int2 deadp = dead_positions(S, Skv, causal, window, q_offset);
  const int dead = deadp.x > 0 || deadp.y < S;
#define FLASH_BWD_ARGS                                                      \
  q, k, v, out, dout, lse, B, S, Skv, H, KV, hd, causal, window, q_offset, \
      scale, inv_n, dead, dq, dk, dv, dbuf
  if (bf16) {
    if (hd <= 64) return launch_tc<64>(FLASH_BWD_ARGS, dob, st);
    if (hd <= 128) return launch_tc<128>(FLASH_BWD_ARGS, dob, st);
    return launch_tc<256>(FLASH_BWD_ARGS, dob, st);
  }
  if (hd <= 64) return launch_simt<64>(FLASH_BWD_ARGS, st);
  if (hd <= 128) return launch_simt<128>(FLASH_BWD_ARGS, st);
  return launch_simt<256>(FLASH_BWD_ARGS, st);
#undef FLASH_BWD_ARGS
}
