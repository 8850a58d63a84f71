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
// 4 * G * n_valid * hd flops).  A decode at batch 1 has one or a few
// (row, kv head) pairs, so the cache is split across blocks to reach the
// card's 132 SMs.
//
// Arithmetic, the same in every launch plan: each (head, slot) score is a
// sequential __fmaf_rn dot over d = 0 .. hd-1, then * scale, then the mask;
// the row max is exact in any order; p = exp(s - m) and the denominator
// are taken in f64 and rounded to f32: exp then rounds as the plain
// version's f64 exp does, and the sum's f32 value does not depend on its
// order (its f64 error is far below an f32 ulp), so the plain version,
// which forms each score in the same order, gets the same weights bit for
// bit, and a weight rounded to bf16 cannot land on the other side of a
// rounding boundary in one version only.  Only the summation order of the
// PV product differs.  No float atomics; the library builds with
// -fmad=false and every multiply-add here is an explicit __fmaf_rn.
//
// Two launch plans, chosen by the wrapper (nsplit):
//
// * nsplit = 1 (B * KV fills the card, or the cache is one tile): one block
//   of 256 threads per (batch row, kv head), three passes in the block.
//   Pass 1 stages 64-slot tiles of k (converted to f32, zero-filled past
//   the end) in shared memory and computes the G x 64 scores with threads
//   over (head, slot); scores go to a global scratch (B, KV, G, C).
//   Pass 2 gives each query head to one warp: its max, then p and l, each
//   lane over slots lane, lane + 32, ... and the lanes joined by a fixed
//   xor tree, then for round_p the normalised, rounded p written back.
//   Pass 3 stages 64-slot tiles of p and of v (read as stored, coalesced)
//   in shared memory; thread d owns output column d and sums p_c * v[c, d]
//   over the slots in order for every head of the group.
// * nsplit > 1: the cache is cut into nsplit chunks of `chunk` slots (whole
//   tiles, the last one ragged) and each pass is a grid of (B * KV, nsplit)
//   blocks, four launches in order on the stream: split_scores (pass 1 on
//   a chunk, plus the chunk's max per head), split_weights (the global max
//   from the chunk maxima, p for the chunk, the chunk's f64 sum of p),
//   split_pv (l as the f64 sum of the chunk sums in a fixed order; for
//   round_p the chunk's weights normalised and rounded; the chunk's PV sums
//   per head and column, in slot order) and split_combine (one block per
//   (row, kv head, head): the chunks' PV sums added in split order,
//   divided by the denominator last without round_p).  The partial
//   maxima, sums and PV sums live in scratch the wrapper allocates.
//
// Tiles of q and of the cache are read with 16-byte loads where the rows
// allow it (hd a multiple of 8 bf16 or 4 f32 values), several in flight.
// The PV pass is instanced on a bound of the group size (1, 2, 4, 8, 16,
// 32), so its accumulators stay in registers and a slot costs no work for
// heads the group does not have.
//
// A cache cut by length over the blocks of a mesh (few kv heads, each
// block holding a slice of every row's slots) takes three more entries,
// for round_p = 1 only (the model's function), with the arithmetic H uses
// between its own chunks.  The stats and PV entries cut each (row, kv
// head)'s slice into split_plan's chunks, so B * KV * nsplit blocks cover
// the SMs at a batch of one row, and stage the cache rows through a
// cp.async double buffer:
//   decode_gqa_stats_launch: over one block's slice, its masked scores
//     (kept, (B, H, C) f32) and each (row, head)'s max m_b and f64 sum of
//     (float)exp(s - m_b).  One chunk: one launch; several: the scores and
//     each chunk's max, then each chunk's f64 sum under the slice's max,
//     the last chunk of a (row, kv head) to finish writing m_b and l_b =
//     the chunk sums added in chunk order;
//   decode_gqa_merge_launch: on the first block's device, the blocks'
//     maxima and sums in block order: m = max m_b, l = (float) sum_b
//     l_b * exp(m_b - m) in f64 (a block with no valid slot adds 0 when
//     another has one; with none anywhere every slot weighs exp(0) = 1, so
//     p = 1 / C as the model's softmax of all -1e30 gives);
//   decode_gqa_pv_launch: over one block's slice, from its kept scores (K
//     is read once per step), p = exp(s - m) / l rounded to the cache's
//     dtype and the slice's PV sums per head and column in slot order, the
//     chunks' sums added in chunk order (split_combine).
// The blocks' PV sums are then added in block order on the first block's
// device.  Scores are formed as in every other plan, so a slot's weight
// differs from the whole cache's only by the rounding of l.
#include <algorithm>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

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

// elements of T in one 16-byte load, and such a load unpacked to f32
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(uint4 u, float* x) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(uint4 u, float* x) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Stage rows c0 .. c0 + TILE - 1 (zeros from c_end on) of a cache's
// ``width`` columns, converted to f32, at dst[row * dst_stride + col]; with
// ``vec`` (rows of whole, aligned 16-byte pieces) one 16-byte load at a
// time, several in flight.
template <typename T>
__device__ __forceinline__ void stage_tile(float* dst, int dst_stride,
                                           const T* src, long src_stride,
                                           int c0, int c_end, int width,
                                           bool vec) {
  if (vec) {
    constexpr int V = Vec<T>::N;
    const int per_row = width / V;
#pragma unroll 4
    for (int i = threadIdx.x; i < TILE * per_row; i += THREADS) {
      const int r = i / per_row, d = (i - r * per_row) * V;
      float x[V];
      if (c0 + r < c_end) {
        Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(
                           src + (long)(c0 + r) * src_stride + d)),
                       x);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) dst[r * dst_stride + d + e] = x[e];
    }
    return;
  }
  for (int i = threadIdx.x; i < TILE * width; i += THREADS) {
    const int r = i / width, d = i % width;
    dst[r * dst_stride + d] =
        c0 + r < c_end ? to_f32(src[(long)(c0 + r) * src_stride + d]) : 0.f;
  }
}

// Where a block's pieces sit: its (row, kv head), the group's query heads
// in shared memory, and its views of the cache, positions and scratch.
template <typename T>
struct Block {
  int row, kvh, G, pos;
  bool vec;                // 16-byte loads of q and the cache rows
  long cstride;            // cache stride per slot
  const T* kr;             // this kv head's k column block at slot 0
  const T* vr;
  const int* sp;           // this row's slot positions
  float* sc;               // scores, then weights: G x C
  float *Qs, *Ts, *Ps, *den;  // shared: G x hd, tile, G x TILE, GMAX

  __device__ Block(int rowkv, const T* k, const T* v, const int* slot_pos,
                   const int* my_pos, int C, int H, int KV, int hd, int vec_,
                   float* scratch, float* smem) {
    vec = vec_;
    row = rowkv / KV;
    kvh = rowkv % KV;
    G = H / KV;
    pos = my_pos[row];
    cstride = (long)KV * hd;
    kr = k + (long)row * C * cstride + (long)kvh * hd;
    vr = v + (long)row * C * cstride + (long)kvh * hd;
    sp = slot_pos + (long)row * C;
    sc = scratch + (long)rowkv * G * C;
    Qs = smem;
    Ts = Qs + G * hd;
    Ps = Ts + TILE * (hd + 1);
    den = Ps + G * TILE;
  }
};

// The group's query heads kvh*G .. kvh*G + G - 1 (contiguous in q) as f32.
template <typename T>
__device__ __forceinline__ void load_q(const Block<T>& bl, const T* q, int H,
                                       int hd) {
  const T* qr = q + ((long)bl.row * H + (long)bl.kvh * bl.G) * hd;
  if (bl.vec) {
    constexpr int V = Vec<T>::N;
    for (int i = threadIdx.x; i < bl.G * hd / V; i += THREADS)
      Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(qr) + i),
                     bl.Qs + V * i);
    return;
  }
  for (int i = threadIdx.x; i < bl.G * hd; i += THREADS)
    bl.Qs[i] = to_f32(qr[i]);
}

// Pass 1 on slots [c_begin, c_end): sc[g * C + c] = the masked score.
template <typename T>
__device__ void scores(const Block<T>& bl, int c_begin, int c_end, int C,
                       int hd, int window, float scale) {
  const int ks = hd + 1;  // padded k row stride
  for (int c0 = c_begin; c0 < c_end; c0 += TILE) {
    __syncthreads();  // Qs written / the previous tile consumed
    stage_tile(bl.Ts, ks, bl.kr, bl.cstride, c0, c_end, hd, bl.vec);
    __syncthreads();
    for (int i = threadIdx.x; i < bl.G * TILE; i += THREADS) {
      const int g = i / TILE, c = c0 + i % TILE;
      if (c >= c_end) continue;
      const float* qg = bl.Qs + g * hd;
      const float* kc = bl.Ts + (c - c0) * ks;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = __fmaf_rn(qg[d], kc[d], s);
      const int p = bl.sp[c];
      const bool valid =
          p >= 0 && p <= bl.pos && (window == 0 || bl.pos - p <= window);
      bl.sc[(long)g * C + c] = valid ? __fmul_rn(s, scale) : NEG;
    }
  }
}

// Pass 3 on slots [c_begin, c_end): acc[g] += w_gc * v[c, d] in slot order
// for thread d < hd, with w = sc, or round(sc / lnorm[g]) when lnorm is set.
// GT >= G bounds the group at compile time (the accumulators stay in
// registers, and no slot pays for heads the group does not have).
template <typename T, int GT>
__device__ void pv(const Block<T>& bl, int c_begin, int c_end, int C, int hd,
                   const float* lnorm, float (&acc)[GT]) {
  const int tid = threadIdx.x;
  for (int c0 = c_begin; c0 < c_end; c0 += TILE) {
    __syncthreads();  // the weights / the previous tiles consumed
    for (int i = tid; i < bl.G * TILE; i += THREADS) {
      const int g = i / TILE, c = c0 + i % TILE;
      float w = c < c_end ? bl.sc[(long)g * C + c] : 0.f;
      if (lnorm != nullptr) w = round_like<T>(__fdiv_rn(w, lnorm[g]));
      bl.Ps[i] = w;
    }
    stage_tile(bl.Ts, hd, bl.vr, bl.cstride, c0, c_end, hd, bl.vec);
    __syncthreads();
    if (tid < hd) {
      const int n = min(TILE, c_end - c0);
      for (int cc = 0; cc < n; ++cc) {
        const float vv = bl.Ts[cc * hd + tid];
#pragma unroll
        for (int g = 0; g < GT; ++g)
          if (g < bl.G) acc[g] = __fmaf_rn(bl.Ps[g * TILE + cc], vv, acc[g]);
      }
    }
  }
}

// ---- nsplit = 1: the three passes in one block per (row, kv head) --------

template <typename T, int GT>
__global__ void __launch_bounds__(THREADS)
    decode_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ slot_pos,
                      const int* __restrict__ my_pos, int C, int H, int KV,
                      int hd, int vec, int window, int round_p, float scale,
                      float ref_count, float* scratch,
                      float* __restrict__ out) {
  extern __shared__ float smem[];
  const Block<T> bl(blockIdx.x, k, v, slot_pos, my_pos, C, H, KV, hd, vec,
                    scratch, smem);
  load_q(bl, q, H, hd);
  scores(bl, 0, C, C, hd, window, scale);
  __syncthreads();  // every score is in the scratch

  // pass 2: softmax weights, one warp per query head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < bl.G; g += THREADS / 32) {
    float* sg = bl.sc + (long)g * C;
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
    if (lane == 0) bl.den[g] = fmaxf(l, 1e-30f);
  }

  float acc[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) acc[g] = 0.f;
  pv(bl, 0, C, C, hd, nullptr, acc);
  const int tid = threadIdx.x;
  if (tid < hd) {
    float* o = out + ((long)bl.row * H + (long)bl.kvh * bl.G) * hd + tid;
#pragma unroll
    for (int g = 0; g < GT; ++g)
      if (g < bl.G)
        o[(long)g * hd] = round_p ? acc[g] : __fdiv_rn(acc[g], bl.den[g]);
  }
}

// ---- nsplit > 1: four launches over (row x kv head, chunk) blocks --------
// Partial results of head g of (row, kv head) rk and chunk s sit at
// [(rk * G + g) * nsplit + s] (and times hd + d for the PV sums).

template <typename T>
__global__ void __launch_bounds__(THREADS)
    split_scores(const T* __restrict__ q, const T* __restrict__ k,
                 const int* __restrict__ slot_pos,
                 const int* __restrict__ my_pos, int C, int H, int KV, int hd,
                 int vec, int window, float scale, int chunk, float* scratch,
                 float* __restrict__ pmax) {
  extern __shared__ float smem[];
  const Block<T> bl(blockIdx.x, k, k, slot_pos, my_pos, C, H, KV, hd, vec,
                    scratch, smem);
  const int s = blockIdx.y, ns = gridDim.y;
  const int c_begin = s * chunk, c_end = min(C, c_begin + chunk);
  load_q(bl, q, H, hd);
  scores(bl, c_begin, c_end, C, hd, window, scale);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < bl.G; g += THREADS / 32) {
    float m = NEG;
    for (int c = c_begin + lane; c < c_end; c += 32)
      m = fmaxf(m, bl.sc[(long)g * C + c]);
    m = warp_max(m);
    if (lane == 0) pmax[((long)blockIdx.x * bl.G + g) * ns + s] = m;
  }
}

// l of head hg, by one warp: the chunk sums of p added lane by lane and
// the lanes joined by a fixed xor tree, rounded to f32 (every lane)
__device__ __forceinline__ float split_l(const double* psum, long hg,
                                         int ns) {
  double l = 0.0;
  for (int j = threadIdx.x & 31; j < ns; j += 32)
    l = __dadd_rn(l, psum[hg * ns + j]);
  return (float)warp_sum(l);
}

// the max of head hg over its chunks, by one warp (every lane)
__device__ __forceinline__ float split_m(const float* pmax, long hg, int ns) {
  float m = NEG;
  for (int j = threadIdx.x & 31; j < ns; j += 32)
    m = fmaxf(m, pmax[hg * ns + j]);
  return warp_max(m);
}

__global__ void __launch_bounds__(THREADS)
    split_weights(int C, int G, int chunk, float* scratch,
                  const float* __restrict__ pmax, double* __restrict__ psum) {
  const int s = blockIdx.y, ns = gridDim.y;
  const int c_begin = s * chunk, c_end = min(C, c_begin + chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < G; g += THREADS / 32) {
    const long hg = (long)blockIdx.x * G + g;
    const float m = split_m(pmax, hg, ns);  // exact in any order
    float* sg = scratch + hg * C;
    double ld = 0.0;
    for (int c = c_begin + lane; c < c_end; c += 32) {
      const float p = (float)exp((double)__fsub_rn(sg[c], m));
      sg[c] = p;
      ld = __dadd_rn(ld, (double)p);
    }
    ld = warp_sum(ld);
    if (lane == 0) psum[hg * ns + s] = ld;
  }
}

template <typename T, int GT>
__global__ void __launch_bounds__(THREADS)
    split_pv(const T* __restrict__ v, const int* __restrict__ slot_pos,
             const int* __restrict__ my_pos, int C, int H, int KV, int hd,
             int vec, int round_p, int chunk, float* scratch,
             const double* __restrict__ psum, float* __restrict__ ppv) {
  extern __shared__ float smem[];
  const Block<T> bl(blockIdx.x, v, v, slot_pos, my_pos, C, H, KV, hd, vec,
                    scratch, smem);
  const int s = blockIdx.y, ns = gridDim.y;
  const int c_begin = s * chunk, c_end = min(C, c_begin + chunk);
  const int tid = threadIdx.x, warp = tid >> 5;
  if (round_p)
    for (int g = warp; g < bl.G; g += THREADS / 32) {
      const float l = split_l(psum, (long)blockIdx.x * bl.G + g, ns);
      if ((tid & 31) == 0) bl.den[g] = l;
    }
  float acc[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) acc[g] = 0.f;
  pv(bl, c_begin, c_end, C, hd, round_p ? bl.den : nullptr, acc);
  if (tid < hd) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
      if (g < bl.G)
        ppv[(((long)blockIdx.x * bl.G + g) * ns + s) * hd + tid] = acc[g];
  }
}

// one block per (row, kv head, head): thread d adds the chunks' PV sums of
// column d in split order
__global__ void __launch_bounds__(THREADS)
    split_combine(int hd, int ns, int round_p, float ref_count,
                  const float* __restrict__ pmax,
                  const double* __restrict__ psum,
                  const float* __restrict__ ppv, float* __restrict__ out) {
  __shared__ float den;
  const long hg = blockIdx.x;
  if (!round_p && threadIdx.x < 32) {
    const float m = split_m(pmax, hg, ns);
    const float l = split_l(psum, hg, ns);
    // no valid slot: the reference's padded count
    if (threadIdx.x == 0) den = fmaxf(m == NEG ? ref_count : l, 1e-30f);
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d >= hd) return;
  const float* pd = ppv + hg * ns * hd + d;
  float o = 0.f;
#pragma unroll 8
  for (int j = 0; j < ns; ++j) o = __fadd_rn(o, pd[(long)j * hd]);
  out[hg * hd + d] = round_p ? o : __fdiv_rn(o, den);
}

// the most shared memory a block of these kernels takes (G = 32, hd = 256)
constexpr int SMEM_MAX =
    sizeof(float) * (GMAX * 256 + TILE * 257 + GMAX * TILE + GMAX);

template <typename K>
int allow_smem(K kern) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
}

// allow the kernels of one cache dtype and group bound SMEM_MAX bytes, once
template <typename T, int GT>
int allow_smem_once() {
  static const int err = [] {
    int e = allow_smem(decode_gqa_kernel<T, GT>);
    if (!e) e = allow_smem(split_scores<T>);
    if (!e) e = allow_smem(split_pv<T, GT>);
    return e;
  }();
  return err;
}

template <typename T, int GT>
int launch(const void* q, const void* k, const void* v, const int* slot_pos,
           const int* my_pos, int B, int C, int H, int KV, int hd,
           int window, int round_p, float scale, float ref_count, int nsplit,
           int chunk, float* scratch, float* pmax, double* psum, float* ppv,
           float* out, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) * ((size_t)G * hd + TILE * (hd + 1) +
                                       (size_t)G * TILE + GMAX);
  const T *qt = (const T*)q, *kt = (const T*)k, *vt = (const T*)v;
  // 16-byte loads: rows of whole 16-byte pieces at 16-byte aligned bases
  const int vec = hd % Vec<T>::N == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  int e = allow_smem_once<T, GT>();
  if (e) return e;
  if (nsplit == 1) {
    decode_gqa_kernel<T, GT><<<B * KV, THREADS, smem, stream>>>(
        qt, kt, vt, slot_pos, my_pos, C, H, KV, hd, vec, window, round_p,
        scale, ref_count, scratch, out);
    return (int)cudaGetLastError();
  }
  const dim3 grid(B * KV, nsplit);
  split_scores<T><<<grid, THREADS, smem, stream>>>(
      qt, kt, slot_pos, my_pos, C, H, KV, hd, vec, window, scale, chunk,
      scratch, pmax);
  if ((e = (int)cudaGetLastError())) return e;
  split_weights<<<grid, THREADS, 0, stream>>>(C, G, chunk, scratch, pmax,
                                              psum);
  if ((e = (int)cudaGetLastError())) return e;
  split_pv<T, GT><<<grid, THREADS, smem, stream>>>(
      vt, slot_pos, my_pos, C, H, KV, hd, vec, round_p, chunk, scratch, psum,
      ppv);
  if ((e = (int)cudaGetLastError())) return e;
  split_combine<<<B * H, (hd + 31) / 32 * 32, 0, stream>>>(
      hd, nsplit, round_p, ref_count, pmax, psum, ppv, out);
  return (int)cudaGetLastError();
}

// the instance whose group bound GT is the least power of two >= G
template <typename T>
int launch_group(int G, const void* q, const void* k, const void* v,
                 const int* slot_pos, const int* my_pos, int B, int C, int H,
                 int KV, int hd, int window, int round_p, float scale,
                 float ref_count, int nsplit, int chunk, float* scratch,
                 float* pmax, double* psum, float* ppv, float* out,
                 cudaStream_t st) {
#define DECODE_GQA_LAUNCH(GT)                                                \
  launch<T, GT>(q, k, v, slot_pos, my_pos, B, C, H, KV, hd, window, round_p, \
                scale, ref_count, nsplit, chunk, scratch, pmax, psum, ppv,   \
                out, st)
  if (G <= 1) return DECODE_GQA_LAUNCH(1);
  if (G <= 2) return DECODE_GQA_LAUNCH(2);
  if (G <= 4) return DECODE_GQA_LAUNCH(4);
  if (G <= 8) return DECODE_GQA_LAUNCH(8);
  if (G <= 16) return DECODE_GQA_LAUNCH(16);
  return DECODE_GQA_LAUNCH(GMAX);
#undef DECODE_GQA_LAUNCH
}

// one thread per (row, head): the nb blocks' maxima and sums in block order
__global__ void slice_merge(const float* __restrict__ pmax,
                            const double* __restrict__ psum, int nb, long n,
                            float* __restrict__ m_out,
                            float* __restrict__ l_out) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float m = pmax[i];
    for (int b = 1; b < nb; ++b) m = fmaxf(m, pmax[(long)b * n + i]);
    double l = 0.0;
    for (int b = 0; b < nb; ++b)
      l = __dadd_rn(l, __dmul_rn(psum[(long)b * n + i],
                                 exp(__dsub_rn((double)pmax[(long)b * n + i],
                                               (double)m))));
    m_out[i] = m;
    l_out[i] = (float)l;
  }
}

// ---- a cache slice of a mesh block: stats (scores kept), merge, PV --------
//
// Each entry cuts every (row, kv head)'s slice into the chunks of the
// wrapper's split_plan and runs a grid of (B * KV, nsplit) blocks, so a
// batch of one row still spreads over the SMs; chunk j holds slots
// [j * chunk, min(C, (j + 1) * chunk)).  A chunk's cache rows go through a
// double buffer of 64-slot tiles in shared memory (16-byte cp.async where
// the rows allow it): the copy of the next tile runs under the current
// tile's dot chains or PV sums.

constexpr int ROW_PAD = 16;      // bytes after each staged cache row
constexpr int SCORE_GROUPS = 4;  // head groups of a tile's scores

// Bytes of one staged cache row: whole 16-byte pieces plus the pad, so the
// rows of 8 consecutive slots start in different 16-byte bank groups when
// a row is a multiple of 32 bytes.
__host__ __device__ __forceinline__ int row_bytes(int hd, int es) {
  return (hd * es + 15) / 16 * 16 + ROW_PAD;
}

// Issue the copies of slots c0 .. c0 + TILE - 1 of a cache column block
// (zeros from c_end on) into a staged tile of rows of rb bytes, as stored:
// with VEC 16-byte cp.async pieces left in flight (the caller commits and
// waits), without element by element, complete on return.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_rows(char* dst, int rb, const T* src,
                                           long stride, int c0, int c_end,
                                           int hd) {
  if (VEC) {
    constexpr int V = Vec<T>::N;
    const int per_row = hd / V;
    for (int i = threadIdx.x; i < TILE * per_row; i += THREADS) {
      const int r = i / per_row, j = i - r * per_row;
      const bool in = c0 + r < c_end;
      acopy::cp_async16(dst + r * rb + 16 * j,
                        src + (long)(in ? c0 + r : c0) * stride + V * j,
                        in ? 16 : 0);
    }
    return;
  }
  using Bits = typename std::conditional<sizeof(T) == 2, uint16_t,
                                         uint32_t>::type;
  const Bits* s = reinterpret_cast<const Bits*>(src);
  for (int i = threadIdx.x; i < TILE * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    reinterpret_cast<Bits*>(dst + r * rb)[d] =
        c0 + r < c_end ? s[(long)(c0 + r) * stride + d] : Bits(0);
  }
}

// The dot chains of one staged row with the query heads g0 + 4 i (i < NH,
// g < G): s[i] = sum_d q[g, d] k[d] as one __fmaf_rn chain over d = 0 ..
// hd-1.  Every lane of a warp takes the same heads, so the q reads are
// broadcasts; each 16-byte piece of k is read once for all NH heads.
template <typename T, int NH, bool VEC>
__device__ __forceinline__ void row_dots(const float* Qs, const char* row,
                                         int hd, int G, int g0,
                                         float (&s)[NH]) {
#pragma unroll
  for (int i = 0; i < NH; ++i) s[i] = 0.f;
  if (VEC) {
    constexpr int V = Vec<T>::N;
    for (int j = 0; j < hd / V; ++j) {
      float kk[V];
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(row + 16 * j), kk);
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        const int g = g0 + SCORE_GROUPS * i;
        if (g < G) {
          const float4* qv =
              reinterpret_cast<const float4*>(Qs + g * hd + V * j);
#pragma unroll
          for (int e = 0; e < V / 4; ++e) {
            const float4 qq = qv[e];
            s[i] = __fmaf_rn(qq.x, kk[4 * e], s[i]);
            s[i] = __fmaf_rn(qq.y, kk[4 * e + 1], s[i]);
            s[i] = __fmaf_rn(qq.z, kk[4 * e + 2], s[i]);
            s[i] = __fmaf_rn(qq.w, kk[4 * e + 3], s[i]);
          }
        }
      }
    }
    return;
  }
  const T* kr = reinterpret_cast<const T*>(row);
  for (int d = 0; d < hd; ++d) {
    const float kd = to_f32(kr[d]);
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int g = g0 + SCORE_GROUPS * i;
      if (g < G) s[i] = __fmaf_rn(Qs[g * hd + d], kd, s[i]);
    }
  }
}

// Scores of one chunk into sc (B, H, C) f32 (kept for the PV entry), then
// per head (one warp each) the chunk's max: into cmax[hg * ns + j] when the
// slice has several chunks (and the pair's count of finished chunks for
// slice_sums set to 0), else the slice's max into pmax and the f64 sum of
// (float)exp(s - max) into psum.  Warp w computes slots (w & 1) * 32 +
// lane of each tile for heads w / 2 + 4 i; the group's q is read once.
template <typename T, int NH, bool VEC>
__global__ void __launch_bounds__(THREADS)
    slice_scores(const T* __restrict__ q, const T* __restrict__ k,
                 const int* __restrict__ slot_pos,
                 const int* __restrict__ my_pos, int C, int H, int KV,
                 int hd, int window, float scale, int chunk,
                 float* __restrict__ sc, float* __restrict__ pmax,
                 double* __restrict__ psum, int* __restrict__ done) {
  extern __shared__ __align__(16) char smem_raw[];
  const int rk = blockIdx.x, row = rk / KV, kvh = rk % KV, G = H / KV;
  const int j = blockIdx.y, ns = gridDim.y;
  if (ns > 1 && j == 0 && threadIdx.x == 0) done[rk] = 0;  // for slice_sums
  const int c_begin = j * chunk, c_end = min(C, c_begin + chunk);
  const int rb = row_bytes(hd, sizeof(T));
  float* Qs = reinterpret_cast<float*>(smem_raw);
  char* ring = smem_raw + ((size_t)G * hd * sizeof(float) + 15) / 16 * 16;
  const long cstride = (long)KV * hd;
  const T* kr = k + (long)row * C * cstride + (long)kvh * hd;
  const int* sp = slot_pos + (long)row * C;
  const int pos = my_pos[row];
  const long hg0 = (long)rk * G;  // = row * H + kvh * G
  float* s_out = sc + hg0 * C;

  stage_rows<T, VEC>(ring, rb, kr, cstride, c_begin, c_end, hd);
  acopy::cp_async_commit();
  const T* qr = q + hg0 * hd;
  for (int i = threadIdx.x; i < G * hd; i += THREADS) Qs[i] = to_f32(qr[i]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = (warp & 1) * 32 + lane, g0 = warp >> 1;
  int t = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += TILE, ++t) {
    const char* cur = ring + (size_t)(t & 1) * TILE * rb;
    if (c0 + TILE < c_end) {
      stage_rows<T, VEC>(ring + (size_t)((t + 1) & 1) * TILE * rb, rb, kr,
                         cstride, c0 + TILE, c_end, hd);
      acopy::cp_async_commit();
      acopy::cp_async_wait<1>();
    } else {
      acopy::cp_async_wait<0>();
    }
    __syncthreads();  // the tile (and q) in shared memory for every thread
    const int c = c0 + cw;
    if (c < c_end && g0 < G) {
      float s[NH];
      row_dots<T, NH, VEC>(Qs, cur + cw * rb, hd, G, g0, s);
      const int p = sp[c];
      const bool valid =
          p >= 0 && p <= pos && (window == 0 || pos - p <= window);
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        const int g = g0 + SCORE_GROUPS * i;
        if (g < G)
          s_out[(long)g * C + c] = valid ? __fmul_rn(s[i], scale) : NEG;
      }
    }
    __syncthreads();  // the tile consumed before its buffer is refilled
  }
  for (int g = warp; g < G; g += THREADS / 32) {
    const float* sg = s_out + (long)g * C;
    float m = NEG;
    for (int c = c_begin + lane; c < c_end; c += 32) m = fmaxf(m, sg[c]);
    m = warp_max(m);
    if (ns > 1) {
      if (lane == 0) pmax[(hg0 + g) * ns + j] = m;
      continue;
    }
    double ld = 0.0;
    for (int c = c_begin + lane; c < c_end; c += 32)
      ld = __dadd_rn(ld, (double)(float)exp((double)__fsub_rn(sg[c], m)));
    ld = warp_sum(ld);
    if (lane == 0) {
      pmax[hg0 + g] = m;
      psum[hg0 + g] = ld;
    }
  }
}

// Several chunks: each chunk's f64 sum of (float)exp(s - m) under the
// slice's max m (the max of the chunk maxima, exact in any order).  The
// last chunk of a (row, kv head) to finish (an integer count, its chunk
// sums fenced before it counts) then writes each head's max and the f64
// sum of its chunk sums in chunk order.
__global__ void __launch_bounds__(THREADS)
    slice_sums(int C, int G, int chunk, const float* __restrict__ sc,
               const float* __restrict__ cmax, double* __restrict__ csum,
               int* __restrict__ done, float* __restrict__ pmax,
               double* __restrict__ psum) {
  __shared__ int last;
  const int j = blockIdx.y, ns = gridDim.y;
  const int c_begin = j * chunk, c_end = min(C, c_begin + chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long hg0 = (long)blockIdx.x * G;
  for (int g = warp; g < G; g += THREADS / 32) {
    const float m = split_m(cmax, hg0 + g, ns);
    const float* sg = sc + (hg0 + g) * C;
    double ld = 0.0;
    for (int c = c_begin + lane; c < c_end; c += 32)
      ld = __dadd_rn(ld, (double)(float)exp((double)__fsub_rn(sg[c], m)));
    ld = warp_sum(ld);
    if (lane == 0) csum[(hg0 + g) * ns + j] = ld;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + blockIdx.x, 1) == ns - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int g = threadIdx.x; g < G; g += THREADS) {
    const long hg = hg0 + g;
    float m = NEG;
    double l = 0.0;
    for (int i = 0; i < ns; ++i) {
      m = fmaxf(m, __ldcg(cmax + hg * ns + i));
      l = __dadd_rn(l, __ldcg(csum + hg * ns + i));
    }
    pmax[hg] = m;
    psum[hg] = l;
  }
}

// One chunk's PV sums from the kept scores: per tile the weights p =
// round(exp(s - m) / l) of the group's heads (f64 exp, taken while the
// tile's v rows are in flight), then thread (hs, d) sums p * v[c, d] in
// slot order for column d of heads hs, hs + groups, ... (groups = 256 /
// hd), GT >= G bounding the accumulators at compile time.  One chunk
// writes the slice's sums to out, several write each chunk's to ppv.
template <typename T, int GT, bool VEC>
__global__ void __launch_bounds__(THREADS)
    slice_pv(const float* __restrict__ sc, const T* __restrict__ v, int C,
             int H, int KV, int hd, int chunk, const float* __restrict__ mrg_m,
             const float* __restrict__ mrg_l, float* __restrict__ out,
             float* __restrict__ ppv) {
  extern __shared__ __align__(16) char smem_raw[];
  const int rk = blockIdx.x, row = rk / KV, kvh = rk % KV, G = H / KV;
  const int j = blockIdx.y, ns = gridDim.y;
  const int c_begin = j * chunk, c_end = min(C, c_begin + chunk);
  const int rb = row_bytes(hd, sizeof(T));
  float* Ws = reinterpret_cast<float*>(smem_raw);  // G x TILE weights
  float* ml = Ws + G * TILE;                       // m then l per head
  char* ring = reinterpret_cast<char*>(ml + 2 * GMAX);
  const long cstride = (long)KV * hd;
  const T* vr = v + (long)row * C * cstride + (long)kvh * hd;
  const long hg0 = (long)rk * G;
  const float* s_in = sc + hg0 * C;

  stage_rows<T, VEC>(ring, rb, vr, cstride, c_begin, c_end, hd);
  acopy::cp_async_commit();
  for (int g = threadIdx.x; g < G; g += THREADS) {
    ml[g] = mrg_m[hg0 + g];
    ml[GMAX + g] = mrg_l[hg0 + g];
  }
  __syncthreads();
  const int groups = max(1, THREADS / hd);
  const int d = threadIdx.x % hd, hs = threadIdx.x / hd;
  const bool active = hs < groups;
  float acc[GT];
#pragma unroll
  for (int i = 0; i < GT; ++i) acc[i] = 0.f;
  int t = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += TILE, ++t) {
    const char* cur = ring + (size_t)(t & 1) * TILE * rb;
    for (int i = threadIdx.x; i < G * TILE; i += THREADS) {
      const int g = i / TILE, c = c0 + i % TILE;
      Ws[i] = c < c_end ? round_like<T>(__fdiv_rn(
                              (float)exp((double)__fsub_rn(
                                  s_in[(long)g * C + c], ml[g])),
                              ml[GMAX + g]))
                        : 0.f;
    }
    if (c0 + TILE < c_end) {
      stage_rows<T, VEC>(ring + (size_t)((t + 1) & 1) * TILE * rb, rb, vr,
                         cstride, c0 + TILE, c_end, hd);
      acopy::cp_async_commit();
      acopy::cp_async_wait<1>();
    } else {
      acopy::cp_async_wait<0>();
    }
    __syncthreads();  // the weights and the v tile in shared memory
    if (active) {
      const int n = min(TILE, c_end - c0);
      const char* col = cur + d * sizeof(T);
      int cc = 0;
      for (; cc + 4 <= n; cc += 4) {
        float vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vv[u] = to_f32(*reinterpret_cast<const T*>(col + (cc + u) * rb));
#pragma unroll
        for (int i = 0; i < GT; ++i) {
          const int g = hs + groups * i;
          if (g < G) {
            const float4 w =
                *reinterpret_cast<const float4*>(Ws + g * TILE + cc);
            acc[i] = __fmaf_rn(w.x, vv[0], acc[i]);
            acc[i] = __fmaf_rn(w.y, vv[1], acc[i]);
            acc[i] = __fmaf_rn(w.z, vv[2], acc[i]);
            acc[i] = __fmaf_rn(w.w, vv[3], acc[i]);
          }
        }
      }
      for (; cc < n; ++cc) {
        const float vc = to_f32(*reinterpret_cast<const T*>(col + cc * rb));
#pragma unroll
        for (int i = 0; i < GT; ++i) {
          const int g = hs + groups * i;
          if (g < G) acc[i] = __fmaf_rn(Ws[g * TILE + cc], vc, acc[i]);
        }
      }
    }
    __syncthreads();  // the weights and the tile consumed
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < GT; ++i) {
    const int g = hs + groups * i;
    if (g < G) {
      if (ns == 1)
        out[(hg0 + g) * hd + d] = acc[i];
      else
        ppv[((hg0 + g) * ns + j) * hd + d] = acc[i];
    }
  }
}

// the most shared memory a slice block takes: the scores' q and ring at
// G = 32, hd = 256 in f32
constexpr int SLICE_SMEM_MAX =
    sizeof(float) * GMAX * 256 + 2 * TILE * (256 * 4 + ROW_PAD);

template <typename K>
int allow_slice_smem(K kern) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SLICE_SMEM_MAX);
}

template <typename T, int GT, bool VEC>
int stats_launch(const T* q, const T* k, const int* slot_pos,
                 const int* my_pos, int B, int C, int H, int KV, int hd,
                 int window, float scale, int nsplit, int chunk, float* sc,
                 float* cmax, double* csum, int* done, float* pmax,
                 double* psum, cudaStream_t st) {
  constexpr int NH = (GT + SCORE_GROUPS - 1) / SCORE_GROUPS;
  static const int attr = allow_slice_smem(slice_scores<T, NH, VEC>);
  if (attr) return attr;
  const int G = H / KV;
  const size_t smem = ((size_t)G * hd * sizeof(float) + 15) / 16 * 16 +
                      2 * (size_t)TILE * row_bytes(hd, sizeof(T));
  const dim3 grid(B * KV, nsplit);
  const bool one = nsplit == 1;
  slice_scores<T, NH, VEC><<<grid, THREADS, smem, st>>>(
      q, k, slot_pos, my_pos, C, H, KV, hd, window, scale, chunk, sc,
      one ? pmax : cmax, psum, done);
  int e = (int)cudaGetLastError();
  if (e || one) return e;
  slice_sums<<<grid, THREADS, 0, st>>>(C, G, chunk, sc, cmax, csum, done,
                                       pmax, psum);
  return (int)cudaGetLastError();
}

template <typename T, int GT, bool VEC>
int pv_launch(const float* sc, const T* v, int B, int C, int H, int KV,
              int hd, int nsplit, int chunk, const float* m, const float* l,
              float* ppv, float* out, cudaStream_t st) {
  static const int attr = allow_slice_smem(slice_pv<T, GT, VEC>);
  if (attr) return attr;
  const int G = H / KV;
  const size_t smem = sizeof(float) * ((size_t)G * TILE + 2 * GMAX) +
                      2 * (size_t)TILE * row_bytes(hd, sizeof(T));
  slice_pv<T, GT, VEC><<<dim3(B * KV, nsplit), THREADS, smem, st>>>(
      sc, v, C, H, KV, hd, chunk, m, l, out, ppv);
  int e = (int)cudaGetLastError();
  if (e || nsplit == 1) return e;
  split_combine<<<B * H, (hd + 31) / 32 * 32, 0, st>>>(hd, nsplit, 1, 0.f,
                                                        nullptr, nullptr,
                                                        ppv, out);
  return (int)cudaGetLastError();
}

// 16-byte staging: rows of whole 16-byte pieces at a 16-byte aligned base
bool vec_rows(int hd, int es, const void* base) {
  return hd * es % 16 == 0 && (uintptr_t)base % 16 == 0;
}

// the instance whose group bound GT is the least power of two >= G (the
// staging element by element takes one instance of the largest bound)
template <typename T>
int stats_group(int G, const void* q, const void* k, const int* slot_pos,
                const int* my_pos, int B, int C, int H, int KV, int hd,
                int window, float scale, int nsplit, int chunk, float* sc,
                float* cmax, double* csum, int* done, float* pmax,
                double* psum, cudaStream_t st) {
  const T *qt = (const T*)q, *kt = (const T*)k;
#define DECODE_GQA_STATS(GT, VEC)                                          \
  stats_launch<T, GT, VEC>(qt, kt, slot_pos, my_pos, B, C, H, KV, hd,     \
                           window, scale, nsplit, chunk, sc, cmax, csum,  \
                           done, pmax, psum, st)
  if (!vec_rows(hd, sizeof(T), k)) return DECODE_GQA_STATS(GMAX, false);
  if (G <= 4) return DECODE_GQA_STATS(4, true);
  if (G <= 8) return DECODE_GQA_STATS(8, true);
  if (G <= 16) return DECODE_GQA_STATS(16, true);
  return DECODE_GQA_STATS(GMAX, true);
#undef DECODE_GQA_STATS
}

template <typename T>
int pv_group(int G, const float* sc, const void* v, int B, int C, int H,
             int KV, int hd, int nsplit, int chunk, const float* m,
             const float* l, float* ppv, float* out, cudaStream_t st) {
  const T* vt = (const T*)v;
#define DECODE_GQA_PV(GT, VEC)                                              \
  pv_launch<T, GT, VEC>(sc, vt, B, C, H, KV, hd, nsplit, chunk, m, l, ppv, \
                        out, st)
  if (!vec_rows(hd, sizeof(T), v)) return DECODE_GQA_PV(GMAX, false);
  if (G <= 1) return DECODE_GQA_PV(1, true);
  if (G <= 2) return DECODE_GQA_PV(2, true);
  if (G <= 4) return DECODE_GQA_PV(4, true);
  if (G <= 8) return DECODE_GQA_PV(8, true);
  if (G <= 16) return DECODE_GQA_PV(16, true);
  return DECODE_GQA_PV(GMAX, true);
#undef DECODE_GQA_PV
}

}  // namespace

// The arguments of the stats and PV entries, packed by the wrapper in one
// struct.pack (decode_gqa.py: _STATS_ARGS, _PV_ARGS) and passed by pointer.
struct StatsArgs {
  const void *q, *k;
  const int *slot_pos, *my_pos;
  float* sc;     // (B, H, C) the slice's masked scores
  float* cmax;   // (B * H * nsplit) the chunks' maxima (nsplit > 1)
  double* csum;  // (B * H * nsplit) the chunks' sums (nsplit > 1)
  int* done;     // (B * KV) the finished chunks of each pair (nsplit > 1)
  float* pmax;   // (B, H)
  double* psum;  // (B, H)
  int B, C, H, KV, hd, window, bf16, nsplit, chunk;
  float scale;
};

struct PVArgs {
  const float* sc;  // (B, H, C) the stats entry's kept scores
  const void* v;
  const float *m, *l;  // (B, H) the merged stats
  float* ppv;          // (B * H * nsplit * hd) the chunks' sums (nsplit > 1)
  float* out;          // (B, H, hd)
  int B, C, H, KV, hd, bf16, nsplit, chunk;
};

extern "C" int decode_gqa_slice_args_size(int pv) {
  return pv ? (int)sizeof(PVArgs) : (int)sizeof(StatsArgs);
}

// one block's slice of the cache: its masked scores, each (row, head)'s
// max and f64 sum of exp(s - max)
extern "C" int decode_gqa_stats_launch(const StatsArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = a->H / a->KV;
  if (a->bf16)
    return stats_group<__nv_bfloat16>(
        G, a->q, a->k, a->slot_pos, a->my_pos, a->B, a->C, a->H, a->KV,
        a->hd, a->window, a->scale, a->nsplit, a->chunk, a->sc, a->cmax,
        a->csum, a->done, a->pmax, a->psum, st);
  return stats_group<float>(G, a->q, a->k, a->slot_pos, a->my_pos, a->B,
                            a->C, a->H, a->KV, a->hd, a->window, a->scale,
                            a->nsplit, a->chunk, a->sc, a->cmax, a->csum,
                            a->done, a->pmax, a->psum, st);
}

// nb blocks' stats, stacked (nb, n) -> the merged m (n,) and l (n,) f32
extern "C" int decode_gqa_merge_launch(const float* pmax, const double* psum,
                                       int nb, long n, float* m, float* l,
                                       void* stream) {
  const int threads = 256;
  const int blocks = (int)std::min<long>((n + threads - 1) / threads, 4096);
  slice_merge<<<blocks, threads, 0, (cudaStream_t)stream>>>(pmax, psum, nb,
                                                            n, m, l);
  return (int)cudaGetLastError();
}

// one block's slice from its kept scores: its PV sums under the merged m
// and l
extern "C" int decode_gqa_pv_launch(const PVArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = a->H / a->KV;
  if (a->bf16)
    return pv_group<__nv_bfloat16>(G, a->sc, a->v, a->B, a->C, a->H, a->KV,
                                   a->hd, a->nsplit, a->chunk, a->m, a->l,
                                   a->ppv, a->out, st);
  return pv_group<float>(G, a->sc, a->v, a->B, a->C, a->H, a->KV, a->hd,
                         a->nsplit, a->chunk, a->m, a->l, a->ppv, a->out,
                         st);
}

extern "C" int decode_gqa_launch(const void* q, const void* k, const void* v,
                                 const int* slot_pos, const int* my_pos,
                                 int B, int C, int H, int KV, int hd,
                                 int window, int round_p, float scale,
                                 float ref_count, int bf16, int nsplit,
                                 int chunk, float* scratch, float* pmax,
                                 double* psum, float* ppv, float* out,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = H / KV;
  if (bf16)
    return launch_group<__nv_bfloat16>(
        G, q, k, v, slot_pos, my_pos, B, C, H, KV, hd, window, round_p, scale,
        ref_count, nsplit, chunk, scratch, pmax, psum, ppv, out, st);
  return launch_group<float>(G, q, k, v, slot_pos, my_pos, B, C, H, KV, hd,
                             window, round_p, scale, ref_count, nsplit, chunk,
                             scratch, pmax, psum, ppv, out, st);
}
