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
// 20 bytes and two flops per element).  A lane's S steps stay one
// dependent chain, so the design works on the data movement only, in the
// shape of the forward (rglru_scan.cu):
// * one warp per block, one lane tile of 32 lanes of one batch row
//   (B * ceil(W / 32) blocks: 128 at the hybrid's prefill), the carry g
//   and a_{t+1} in registers;
// * a, h and dh reach the warp through a ring of STAGES stages in shared
//   memory, each a tile of TS steps x 32 lanes of each array, walked from
//   the end of the sequence (step tile n - 1 first) and filled STAGES - 1
//   tiles ahead of the scan.  The h tile is staged one step behind the a
//   and dh tiles (steps t0 - 1 .. t0 + TS - 2 for the tile at t0), so a
//   tile's first step finds h_{t-1} in its own stage (the last step of the
//   next tile down); at t = 0 it takes h0;
// * TMA path (W % 4 == 0 and every pointer 16-byte aligned): lane 0
//   issues one 3-D TMA box per array and stage, completion on the stage's
//   mbarrier, the box zero-filled past S, past W and before step 0; da and
//   db are staged in one of two tile pairs and written back by TMA stores
//   (clipped at S and W) while the next tile is scanned;
// * cp.async path (any other W or alignment): each lane copies its own
//   column of the tile with 4-byte cp.async (zero-filled out of bounds),
//   one commit group per stage, waits on its own groups, and stores da and
//   db directly, one coalesced 128-byte store per warp and step.
// The host picks the path (kernels/rglru_scan.py:copy_path) and lists the
// reverse tiles (kernels/rglru_scan.py:bwd_tile_plan).  The scan reads
// UNROLL steps of a, h and dh from shared memory into registers before
// their products and sums, so only those are on the chain.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int LANES = 32;         // lanes per block: one warp
constexpr int TS = 32;            // steps per stage tile
constexpr int STAGES = 6;         // tiles in the ring
constexpr int UNROLL = 8;         // steps read ahead of the chain
constexpr int TILE = TS * LANES;  // floats of one array's stage tile
constexpr int OUT_BUFS = 2;       // (da, db) tile pairs of the TMA stores
constexpr int SMEM_BYTES =
    (3 * STAGES + 2 * OUT_BUFS) * TILE * 4 + STAGES * 8 + 128;  // + align
static_assert(TS % UNROLL == 0 && TS <= 256, "TMA boxes hold <= 256 steps");

// the reverse chain over ``steps`` steps of one stage tile, last step
// first (A, Hp, Gt point at this lane's column, stride LANES; Hp[j] is
// h_{t-1} of step j), storing db_t at ob[j * stride] and da_t at
// oa[j * stride]; first: the tile holds step 0, whose h_{t-1} is h0
__device__ __forceinline__ void scan_tile(const float* A, const float* Hp,
                                          const float* Gt, int steps,
                                          bool first, float h0, float& g,
                                          float& a_next, float* oa, float* ob,
                                          long stride, bool live) {
  if (steps == TS) {
#pragma unroll 1
    for (int j0 = TS - UNROLL; j0 >= 0; j0 -= UNROLL) {
      float av[UNROLL], hv[UNROLL], gv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        av[u] = A[(j0 + u) * LANES];
        hv[u] = Hp[(j0 + u) * LANES];
        gv[u] = Gt[(j0 + u) * LANES];
      }
      if (first && j0 == 0) hv[0] = h0;
#pragma unroll
      for (int u = UNROLL - 1; u >= 0; --u) {
        g = __fadd_rn(__fmul_rn(a_next, g), gv[u]);
        if (live) {
          ob[(j0 + u) * stride] = g;
          oa[(j0 + u) * stride] = __fmul_rn(g, hv[u]);
        }
        a_next = av[u];
      }
    }
  } else {
    for (int j = steps - 1; j >= 0; --j) {
      g = __fadd_rn(__fmul_rn(a_next, g), Gt[j * LANES]);
      const float hp = first && j == 0 ? h0 : Hp[j * LANES];
      if (live) {
        ob[j * stride] = g;
        oa[j * stride] = __fmul_rn(g, hp);
      }
      a_next = A[j * LANES];
    }
  }
}

__device__ __forceinline__ void tma_store_3d(const void* map, const void* src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(acopy::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <bool TMA>
__global__ void __launch_bounds__(LANES)
    rglru_scan_bwd_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap th,
                          const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ CUtensorMap tda,
                          const __grid_constant__ CUtensorMap tdb,
                          const float* __restrict__ a,
                          const float* __restrict__ h0,
                          const float* __restrict__ h,
                          const float* __restrict__ dh, int S, int W,
                          int n_tiles, float* __restrict__ da,
                          float* __restrict__ db, float* __restrict__ dh0) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((128 - (acopy::smem_u32(smem_raw) & 127)) & 127);
  float* ring = reinterpret_cast<float*>(base);  // stage s: a, h, dh
  float* outs = ring + 3 * STAGES * TILE;        // TMA store buffers
  uint64_t* bars = reinterpret_cast<uint64_t*>(outs + 2 * OUT_BUFS * TILE);

  const int lane = threadIdx.x;
  const int row = blockIdx.x / n_tiles;
  const int w0 = blockIdx.x % n_tiles * LANES;
  const int w = w0 + lane;
  const bool live = w < W;
  const int n = (S + TS - 1) / TS;
  const long rbase = (long)row * S * W;

  // the i-th tile of the walk (step tile n - 1 - i) into stage i % STAGES
  auto issue = [&](int i) {
    float* A = ring + 3 * (i % STAGES) * TILE;
    const int t0 = (n - 1 - i) * TS;
    if (TMA) {
      uint64_t* bar = &bars[i % STAGES];
      acopy::mbar_expect_tx(bar, 3 * TILE * 4);
      acopy::tma_load_3d(A, &ta, bar, w0, t0, row);
      acopy::tma_load_3d(A + TILE, &th, bar, w0, t0 - 1, row);
      acopy::tma_load_3d(A + 2 * TILE, &tg, bar, w0, t0, row);
    } else {
      if (i < n) {
        A += lane;
        for (int j = 0; j < TS; ++j) {
          const int t = t0 + j;
          const bool ok = live && t < S;
          const long off = ok ? rbase + (long)t * W + w : 0;
          acopy::cp_async4(A + j * LANES, a + off, ok ? 4 : 0);
          const bool hp = ok && t > 0;  // h_{t-1}; zero at t = 0
          acopy::cp_async4(A + TILE + j * LANES, h + (hp ? off - W : 0),
                           hp ? 4 : 0);
          acopy::cp_async4(A + 2 * TILE + j * LANES, dh + off, ok ? 4 : 0);
        }
      }
      acopy::cp_async_commit();  // empty past the end: counts stay uniform
    }
  };

  if (TMA) {
    if (lane == 0) {
      for (int s = 0; s < STAGES; ++s) acopy::mbar_init(&bars[s], 1);
      acopy::mbar_fence_init();
      for (int i = 0; i < STAGES && i < n; ++i) issue(i);
    }
    __syncwarp();
  } else {
    for (int i = 0; i < STAGES; ++i) issue(i);
  }

  const float hz = live ? h0[(long)row * W + w] : 0.f;
  float g = 0.f;
  float a_next = 0.f;  // a_{t+1}; 0 past the end, so g_{S-1} = dh_{S-1}
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const int t0 = (n - 1 - i) * TS;
    if (TMA)
      acopy::mbar_wait(&bars[s], (i / STAGES) & 1);
    else
      acopy::cp_async_wait<STAGES - 1>();
    const float* A = ring + 3 * s * TILE + lane;
    const int steps = min(TS, S - t0);
    if (TMA) {
      // da and db staged in one of two tile pairs, written back by TMA
      // stores (clipped at S and W) while the next tile is scanned
      float* so = outs + 2 * (i & 1) * TILE;
      if (i >= 2) {
        if (lane == 0)
          asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        __syncwarp();
      }
      scan_tile(A, A + TILE, A + 2 * TILE, steps, t0 == 0, hz, g, a_next,
                so + lane, so + TILE + lane, LANES, true);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        tma_store_3d(&tda, so, w0, t0, row);
        tma_store_3d(&tdb, so + TILE, w0, t0, row);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    } else {
      const long off = rbase + (long)t0 * W + w;
      scan_tile(A, A + TILE, A + 2 * TILE, steps, t0 == 0, hz, g, a_next,
                da + off, db + off, W, live);
    }
    __syncwarp();  // every lane has read stage s before it is refilled
    if (!TMA)
      issue(i + STAGES);
    else if (lane == 0 && i + STAGES < n)
      issue(i + STAGES);
  }
  if (live) dh0[(long)row * W + w] = __fmul_rn(a_next, g);
  if (TMA && lane == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

using acopy::EncodeTiled;

// an f32 tensor (B, S, W) row-major as a 3-D TMA map whose box is 32 lanes
// x TS steps x 1 row, no swizzle, zeros out of bounds
int encode(EncodeTiled fn, CUtensorMap* map, const float* p, int B, int S,
           int W) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)S * W * 4};
  const cuuint32_t box[3] = {LANES, TS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                  const_cast<float*>(p), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : acopy::ERR_ENCODE + (int)r;
}

template <bool TMA>
int launch(const CUtensorMap* maps, const float* a, const float* h0,
           const float* h, const float* dh, int S, int W, int n_tiles,
           long blocks, float* da, float* db, float* dh0,
           cudaStream_t stream) {
  auto kern = rglru_scan_bwd_kernel<TMA>;
  static const int e = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e) return e;
  kern<<<(unsigned)blocks, LANES, SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], a, h0, h, dh, S, W,
      n_tiles, da, db, dh0);
  return (int)cudaGetLastError();
}

}  // namespace

// a, h, dh (B, S, W) and h0 (B, W) f32, contiguous -> da, db (B, S, W) and
// dh0 (B, W) f32; tma != 0 takes the TMA path, which the wrapper sets only
// where W % 4 == 0 and a, h, dh, da and db are 16-byte aligned
extern "C" int rglru_scan_bwd_launch(const float* a, const float* h0,
                                     const float* h, const float* dh, int B,
                                     int S, int W, int tma, float* da,
                                     float* db, float* dh0, void* stream) {
  const int n_tiles = (W + LANES - 1) / LANES;
  const long blocks = (long)B * n_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap maps[5] = {};
  cudaStream_t st = (cudaStream_t)stream;
  if (!tma)
    return launch<false>(maps, a, h0, h, dh, S, W, n_tiles, blocks, da, db,
                         dh0, st);
  EncodeTiled fn = acopy::encoder();
  if (fn == nullptr) return acopy::ERR_NO_ENCODER;
  const float* src[5] = {a, h, dh, da, db};
  for (int i = 0; i < 5; ++i) {
    const int err = encode(fn, &maps[i], src[i], B, S, W);
    if (err) return err;
  }
  return launch<true>(maps, a, h0, h, dh, S, W, n_tiles, blocks, da, db, dh0,
                      st);
}
