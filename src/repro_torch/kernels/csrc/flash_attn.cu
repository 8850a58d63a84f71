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
// Two kernels, picked by the dtype (no fallback from one to the other):
//
// * bf16: flash_tc_kernel, on the tensor cores.  One warpgroup (128
//   threads) per 64 query rows, one per block (two at hd 256); a query row
//   is (position, head of the kv group), so a block covers P = 64/G
//   positions (128/G), rounded down, and all G heads, and each k/v tile is
//   loaded once for the whole group.  Causal blocks run longest first.  TMA
//   brings the q tile and a ring of two (k, v) tile stages into shared
//   memory as bf16 (128-byte swizzle, completion on mbarriers), issued by
//   one thread: the load of tile t + 2 runs while tile t + 1 is computed.
//   The head dim is padded to 64, 128 or 256 with zeros by the TMA's
//   out-of-bounds fill, and keys past Skv arrive as zero rows.
//   S = Q K^T runs on the f64 tensor cores (mma.sync m16n8k16, operands
//   converted from the bf16 tiles): a bf16 product is exact in f64 and so
//   are the sums, so each score is the f32 rounding of its exact dot
//   product, which the plain version forms too (an f64 einsum).  The
//   scores must agree bit for bit: p is rounded to bf16 before the PV
//   product, and a score an ulp off moves p across a rounding boundary in
//   one version only (a gap of up to ~1e-3 at 1e-5 tolerance); the bf16
//   wgmma's own sum order did that on the H100, and wgmma has no f64 form.
//   The online softmax runs in registers on the accumulator layout (a
//   row's 64 scores over the 4 lanes of a quad); l sums the unrounded f32
//   p; p is rounded to bf16 and fed as wgmma's register A operand for
//   O += P V (m64n64k16, f32 accumulators), v read from shared memory as
//   an MN-major operand.  A tile's PV product goes into its own
//   accumulator 64 output columns at a time, then acc = acc * alpha + pv,
//   as the plain version writes it.  At hd 256 the output accumulator is
//   128 f32 registers a thread.
// * f32: flash_attn_kernel, SIMT (the CUDA cores), 128 threads per block
//   of 64 query rows: thread (ty, tx) = (tid / 8, tid % 8) owns rows
//   4*ty .. 4*ty+3, the keys tx + 8 j of each tile's score matrix and the
//   columns tx + 8 c of the output; tiles staged as f32 in shared memory,
//   products as __fmaf_rn chains.
//
// Any group G <= 64 (H % KV == 0): a block of R rows (64, or 128 at bf16
// hd 256) takes P = R / G whole positions, rounded down, so its rows
// r < P * G map to (position p0 + r / G, head kvh * G + r % G) in the q
// load, the tile skip test and the output store alike; the last R - P * G
// rows are padding.  They load zeros (the bf16 kernel zero-fills them in
// shared memory; TMA writes only the P * G rows of its box), go through the
// products like any row (wgmma's M tile is 64 rows), and are never stored.
//
// In both, the kv loop lives inside the block (Hopper blocks run in no
// order; the TPU grid's sequential kv axis becomes this loop).  Tiles
// masked for every row of the block are skipped when every row sees at
// least one real key (such a tile changes no bit of the result).  A row
// that sees no real key at all gets the reference's value: its online
// softmax takes p = 1 on every key, so acc is the sum of v, and l becomes
// the reference's padded key count.  Ragged edges are masked in the
// kernel, never padded in memory.  No library attention or matmul.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // SIMT: 16 row groups x 8 lanes
constexpr float NEG = -1e30f;

__device__ __forceinline__ bool unmasked(int qpos, int kpos, int Skv,
                                         int causal, int window) {
  return kpos < Skv && (!causal || qpos >= kpos) &&
         (!window || qpos - kpos <= window);
}

// The kv tiles [t_lo, t_hi] that a block of query positions p0 .. pos_hi
// must visit: all of them unless every row sees a real key, in which case
// the tiles masked for every row are dropped.
__device__ __forceinline__ void tile_range(int p0, int pos_hi, int Skv,
                                           int causal, int window,
                                           int q_offset, int* t_lo,
                                           int* t_hi) {
  const int n_tiles = (Skv + BK - 1) / BK;
  const int qmin = p0 + q_offset, qmax = pos_hi + q_offset;
  const bool all_live = Skv > 0 && (!causal || qmin >= 0) &&
                        (!window || qmax - window <= Skv - 1);
  *t_lo = 0;
  *t_hi = n_tiles - 1;
  if (all_live) {
    if (causal) *t_hi = min(*t_hi, qmax / BK);
    if (window) *t_lo = max(0, (qmin - window) / BK);
  }
}

// --------------------------------------------------------------------------
// f32: SIMT kernel
// --------------------------------------------------------------------------

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

template <int HDMAX>
__global__ void __launch_bounds__(THREADS)
    flash_attn_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, int S, int Skv, int H,
                      int KV, int hd, int causal, int window, int q_offset,
                      float scale, float ref_kv_count,
                      float* __restrict__ out, float* __restrict__ lse) {
  constexpr int CPT = HDMAX / 8;  // output columns per thread
  extern __shared__ float smem[];
  const int ks = hd + 1;          // padded row stride of q/k tiles
  float* Qs = smem;               // BQ x ks
  float* Ks = Qs + BQ * ks;       // BK x ks
  float* Vs = Ks + BK * ks;       // BK x hd
  float* Ps = Vs + BK * hd;       // BQ x (BK + 1)

  const int G = H / KV;
  const int ppb = BQ / G;                      // positions per block
  const int live = ppb * G;                    // rows past this are padding
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
    if (r < live && pos < S)
      x = q[((long)b * S + pos) * qrow + (long)(kvh * G + r % G) * hd + d];
    Qs[r * ks + d] = x;
  }

  int t_lo, t_hi;
  tile_range(p0, min(p0 + ppb, S) - 1, Skv, causal, window, q_offset, &t_lo,
             &t_hi);

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
        kx = k[off];
        vx = v[off];
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
        Ps[(ty * 4 + i) * (BK + 1) + tx + 8 * j] = p;
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
    if (r >= live || pos >= S) continue;
    float li = m[i] == NEG ? ref_kv_count : l[i];
    float den = fmaxf(li, 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((long)b * S + pos) * H + kvh * G + r % G] =
          m[i] == NEG ? NEG : __fadd_rn(m[i], logf(li));
    float* o = out + ((long)b * S + pos) * qrow + (long)(kvh * G + r % G) * hd;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      int col = tx + 8 * c;
      if (col < hd) o[col] = __fdiv_rn(acc[i][c], den);
    }
  }
}

template <int HDMAX>
int launch_simt(const void* q, const void* k, const void* v, int B, int S,
                int Skv, int H, int KV, int hd, int causal, int window,
                int q_offset, float scale, float ref_kv_count, float* out,
                float* lse, cudaStream_t stream) {
  auto smem_for = [](int d) {
    return (int)sizeof(float) * (BQ * (d + 1) + BK * (d + 1) + BK * d +
                                 BQ * (BK + 1));
  };
  auto kern = flash_attn_kernel<HDMAX>;
  static const int e = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_for(HDMAX));
  if (e) return e;
  const int smem = smem_for(hd);
  const int ppb = BQ / (H / KV);
  dim3 grid((S + ppb - 1) / ppb, B * KV);
  kern<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, S, Skv, H, KV, hd,
      causal, window, q_offset, scale, ref_kv_count, out, lse);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// bf16: tensor-core kernel (TMA, mbarriers, wgmma)
// --------------------------------------------------------------------------

using acopy::mbar_expect_tx;
using acopy::mbar_init;
using acopy::mbar_wait;
using acopy::smem_u32;
using tc::fence_regs;
using tc::gmma_desc;
using tc::mma_rs;
using tc::pack_bf16;
using tc::ROW_BYTES;
using tc::tma_load;
using tc::wg_commit;
using tc::wg_fence;
using tc::wg_wait_all;

// d (16 x 8 f64) += a (16 x 16) * b (16 x 8) on the f64 tensor cores, with
// g = lane/4, t = lane%4: a[i] = a[g + 8 (i & 1)][t + 4 (i >> 1)],
// b_m = b[t + 4m][g], d[2h + i] = d[g + 8h][2t + i]
__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[8],
                                       double b0, double b1, double b2,
                                       double b3) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b0), "d"(b1), "d"(b2), "d"(b3));
}

// the two bf16 at (row r, columns d and d + 1; d even) of a tile stored as
// 64-column blocks of ``rows`` swizzled 128-byte rows, as TMA wrote it
__device__ __forceinline__ uint32_t tile_pair(const uint8_t* t, int rows,
                                              int r, int d) {
  const int off = (d >> 6) * rows * ROW_BYTES + r * ROW_BYTES +
                  ((((d & 63) >> 3) ^ (r & 7)) << 4) + (d & 7) * 2;
  return *reinterpret_cast<const uint32_t*>(t + off);
}

// two packed bf16 as exact f64 values (low half first)
__device__ __forceinline__ void bf16x2_f64(uint32_t u, double (&x)[2]) {
  x[0] = (double)__uint_as_float(u << 16);
  x[1] = (double)__uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The tensor-core kernel's block for a padded head dim: NWG consumer
// warpgroups of 64 query rows each (two at hd 256, where one warpgroup's
// registers leave the SM one block: the second overlaps its softmax with
// the first's products and shares its k/v tiles), and its shared memory,
// each part 1,024-byte aligned: q as HDP/64 blocks of [ROWS rows][64
// columns], then two stages of k and of v, each HDP/64 blocks of [64
// keys][64 columns], then the mbarriers.
template <int HDP>
struct TcShape {
  static constexpr int NB = HDP / 64;
  static constexpr int NWG = HDP == 256 ? 2 : 1;
  static constexpr int ROWS = 64 * NWG;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int Q_BYTES = ROWS * HDP * 2;
  static constexpr int T_BYTES = BK * HDP * 2;
  static constexpr int BAR_OFF = Q_BYTES + 4 * T_BYTES;
  static constexpr int BYTES = BAR_OFF + 64 + 1024;  // + alignment slack
};

// tile i of a block's range into stage i % 2: k and v, all NB column blocks
template <int NB>
__device__ __forceinline__ void load_kv(uint8_t* Ks, uint8_t* Vs, int t_bytes,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint64_t* bars,
                                        int i, int t_lo, int kvh, int b) {
  const int s = i & 1, k0 = (t_lo + i) * BK;
  mbar_expect_tx(&bars[1 + s], 2 * t_bytes);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    tma_load(Ks + s * t_bytes + c * BK * ROW_BYTES, tk, &bars[1 + s], c * 64,
             kvh, k0, b);
    tma_load(Vs + s * t_bytes + c * BK * ROW_BYTES, tv, &bars[1 + s], c * 64,
             kvh, k0, b);
  }
}

template <int HDP>
__global__ void __launch_bounds__(TcShape<HDP>::THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, int S, int Skv,
                    int H, int KV, int hd, int causal, int window,
                    int q_offset, float scale, float ref_kv_count,
                    float* __restrict__ out, float* __restrict__ lse) {
  using L = TcShape<HDP>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;
  uint8_t* Ks = base + L::Q_BYTES;                    // stage s at s * T_BYTES
  uint8_t* Vs = base + L::Q_BYTES + 2 * L::T_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  // bars[0]: q; bars[1 + s]: stage s of (k, v)

  // one block per (query tile, batch x kv head), the last query tiles (the
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

  int t_lo, t_hi;
  tile_range(p0, min(p0 + ppb, S) - 1, Skv, causal, window, q_offset, &t_lo,
             &t_hi);
  const int n = t_hi - t_lo + 1;
  const int qmin = p0 + q_offset, qmax = min(p0 + ppb, S) - 1 + q_offset;

  // the padding rows of the q tile, zero in every column block (TMA
  // writes only the box's live rows)
  for (int i = tid; i < NB * (L::ROWS - live) * (ROW_BYTES / 16);
       i += L::THREADS) {
    const int c = i / ((L::ROWS - live) * (ROW_BYTES / 16));
    const int rest = i % ((L::ROWS - live) * (ROW_BYTES / 16));
    *reinterpret_cast<uint4*>(Qs + c * L::ROWS * ROW_BYTES +
                              (live + rest / (ROW_BYTES / 16)) * ROW_BYTES +
                              rest % (ROW_BYTES / 16) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init(&bars[2], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid == 0) {
    mbar_expect_tx(&bars[0], NB * live * ROW_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_load(Qs + c * L::ROWS * ROW_BYTES, &tq, &bars[0], c * 64, kvh * G,
               p0, b);
    for (int i = 0; i < 2 && i < n; ++i)
      load_kv<NB>(Ks, Vs, L::T_BYTES, &tk, &tv, bars, i, t_lo, kvh, b);
  }
  __syncwarp();

  // accumulator layout of a 64 x 64 wgmma: warp w holds rows 16 w + lane/4
  // (elements e with e & 2 == 0) and 16 w + lane/4 + 8 (e & 2 != 0), at
  // columns 8 (e / 4) + 2 (lane % 4) + (e & 1)
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int hd16 = (hd + 15) & ~15;  // head dims the score products visit
  const int qpos[2] = {p0 + r0 / G + q_offset, p0 + (r0 + 8) / G + q_offset};
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;

  mbar_wait(&bars[0], 0);
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    const int k0 = (t_lo + i) * BK;
    mbar_wait(&bars[1 + s], (i >> 1) & 1);
    __syncwarp();

    // ---- S = Q K^T, each score the f32 rounding of its exact dot ---------
    // product: bf16 products are exact in f64 and the f64 sums of this
    // data are too, so the order does not matter and the plain version's
    // f64 einsum rounds to the same f32.  Warp w computes its 16 rows
    // against keys 8 j + lane/4 in m16n8k16 steps on the f64 tensor cores;
    // step k16 at head dims D .. D + 15 gives lane % 4 = t the dims D + 2t,
    // D + 2t + 1, D + 8 + 2t and D + 9 + 2t (two bf16 pairs per row or
    // key), for A and B alike.  The f64 result lands in the wgmma
    // accumulator layout: rows 16 w + lane/4 (+ 8), keys 8 j + 2t + 0/1.
    // At hd 256 half of the keys at a time keeps the f64 accumulators at
    // 32 registers beside the 128 of the output.
    constexpr int NJ = HDP == 256 ? 4 : 8;  // key blocks of 8 per pass
    float sc[32];
    const uint8_t* Kst = Ks + s * L::T_BYTES;
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += NJ) {
      double sd[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sd[j][i] = 0.0;
#pragma unroll 2
      for (int d0 = cq; d0 < hd16; d0 += 16) {
        double a[8];  // a[2m + h]: row r0 + 8h, dim d(m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          double x[2], y[2];
          bf16x2_f64(tile_pair(Qs, L::ROWS, r0 + 8 * h, d0), x);
          bf16x2_f64(tile_pair(Qs, L::ROWS, r0 + 8 * h, d0 + 8), y);
          a[h] = x[0];
          a[2 + h] = x[1];
          a[4 + h] = y[0];
          a[6 + h] = y[1];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int key = 8 * (j0 + j) + (lane >> 2);
          double bx[2], by[2];
          bf16x2_f64(tile_pair(Kst, BK, key, d0), bx);
          bf16x2_f64(tile_pair(Kst, BK, key, d0 + 8), by);
          dmma16(sd[j], a, bx[0], bx[1], by[0], by[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[4 * (j0 + j) + i] = (float)sd[j][i];
    }

    // ---- online softmax in registers -------------------------------------
    // a tile every row of the block sees whole needs no mask test
    const bool whole = k0 + BK <= Skv && (!causal || qmin >= k0 + BK - 1) &&
                       (!window || qmax - k0 <= window);
    float mx[2] = {NEG, NEG};
    if (whole) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        sc[e] = __fmul_rn(sc[e], scale);
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h = (e >> 1) & 1;
        const int kpos = k0 + 8 * (e >> 2) + cq + (e & 1);
        sc[e] = unmasked(qpos[h], kpos, Skv, causal, window)
                    ? __fmul_rn(sc[e], scale)
                    : NEG;
        mx[h] = fmaxf(mx[h], sc[e]);
      }
    }
    float alpha[2], ps[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(__fsub_rn(m[h], m_new[h]));
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1;
      sc[e] = expf(__fsub_rn(sc[e], m_new[h]));
      ps[h] = __fadd_rn(ps[h], sc[e]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), quad_sum(ps[h]));
      m[h] = m_new[h];
    }
    // p rounded to bf16 as wgmma's A fragments, 16 keys each: rows r0 and
    // r0 + 8, keys 16 kc + cq (+1) and 16 kc + 8 + cq (+1)
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      pa[kc][0] = pack_bf16(sc[8 * kc + 0], sc[8 * kc + 1]);
      pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
      pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
      pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
    }

    // ---- acc = acc * alpha + P V, 64 output columns at a time ------------
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      float pv[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) pv[e] = 0.f;
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        mma_rs(pv, pa[kc],
               gmma_desc(Vs + s * L::T_BYTES + c * BK * ROW_BYTES +
                             kc * 16 * ROW_BYTES,
                         BK * ROW_BYTES, 1024));
      wg_commit();
      wg_wait_all();
      fence_regs(pv);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        acc[c][e] =
            __fadd_rn(__fmul_rn(acc[c][e], alpha[(e >> 1) & 1]), pv[e]);
    }

    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && i + 2 < n)
      load_kv<NB>(Ks, Vs, L::T_BYTES, &tk, &tv, bars, i + 2, t_lo, kvh, b);
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int pos = p0 + r / G;
    if (r >= live || pos >= S) continue;
    const float li = m[h] == NEG ? ref_kv_count : l[h];
    const float den = fmaxf(li, 1e-30f);
    if (lse != nullptr && (lane & 3) == 0)
      lse[((long)b * S + pos) * H + kvh * G + r % G] =
          m[h] == NEG ? NEG : __fadd_rn(m[h], logf(li));
    float* o = out + (((long)b * S + pos) * H + kvh * G + r % G) * hd;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 64 + 8 * j + cq;
        if (col < hd)
          *reinterpret_cast<float2*>(o + col) =
              make_float2(__fdiv_rn(acc[c][4 * j + 2 * h], den),
                          __fdiv_rn(acc[c][4 * j + 2 * h + 1], den));
      }
  }
}

using acopy::encoder;
using acopy::EncodeTiled;
using acopy::ERR_NO_ENCODER;

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, int B, int S,
              int Skv, int H, int KV, int hd, int causal, int window,
              int q_offset, float scale, float ref_kv_count, float* out,
              float* lse, cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  using L = TcShape<HDP>;
  const int G = H / KV, ppb = L::ROWS / G;
  CUtensorMap tq, tk, tv;
  int err = tc::encode(fn, &tq, q, hd, H, S, B, G, ppb);
  if (!err) err = tc::encode(fn, &tk, k, hd, KV, Skv, B, 1, BK);
  if (!err) err = tc::encode(fn, &tv, v, hd, KV, Skv, B, 1, BK);
  if (err) return err;
  const int smem = L::BYTES;
  auto kern = flash_tc_kernel<HDP>;
  static const int e = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  const long blocks = (long)((S + ppb - 1) / ppb) * B * KV;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, L::THREADS, smem, stream>>>(
      tq, tk, tv, S, Skv, H, KV, hd, causal, window, q_offset, scale,
      ref_kv_count, out, lse);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 takes the tensor-core kernel (hd <= 256, hd % 8 == 0: the TMA
// strides are whole 16 bytes), f32 the SIMT kernel (hd <= 256); the wrapper
// checks both before it calls.  lse (B, S, H) f32, or null: each row's
// log-sum-exp m + log(l) for the backward (-1e30 where no key is seen).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 int B, int S, int Skv, int H, int KV, int hd,
                                 int causal, int window, int q_offset,
                                 float scale, int bf16, float* out,
                                 void* stream, float* lse) {
  int bk = Skv < 128 ? Skv : 128;  // the reference's kv tile
  float ref_kv_count = bk > 0 ? (float)((Skv + bk - 1) / bk * bk) : 0.f;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    if (hd <= 64)
      return launch_tc<64>(q, k, v, B, S, Skv, H, KV, hd, causal, window,
                           q_offset, scale, ref_kv_count, out, lse, st);
    if (hd <= 128)
      return launch_tc<128>(q, k, v, B, S, Skv, H, KV, hd, causal, window,
                            q_offset, scale, ref_kv_count, out, lse, st);
    return launch_tc<256>(q, k, v, B, S, Skv, H, KV, hd, causal, window,
                          q_offset, scale, ref_kv_count, out, lse, st);
  }
  if (hd <= 64)
    return launch_simt<64>(q, k, v, B, S, Skv, H, KV, hd, causal, window,
                           q_offset, scale, ref_kv_count, out, lse, st);
  if (hd <= 128)
    return launch_simt<128>(q, k, v, B, S, Skv, H, KV, hd, causal, window,
                            q_offset, scale, ref_kv_count, out, lse, st);
  return launch_simt<256>(q, k, v, B, S, Skv, H, KV, hd, causal, window,
                          q_offset, scale, ref_kv_count, out, lse, st);
}
