// rglru_scan: the RG-LRU's diagonal linear recurrence (kernel I).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py:rglru_scan.
// a, b (B, S, W) f32 and h0 (B, W) f32 -> h (B, S, W) f32 with
// h_t = a_t * h_{t-1} + b_t, formed as one fused multiply-add
// (__fmaf_rn), as the reference kernel and its oracle form it on the CPU;
// the library builds with -fmad=false, so no other product is contracted.
// The result is bit-equal to the plain PyTorch version
// (repro_torch.kernels.rglru_scan.rglru_scan_plain).
//
// Bound on the H100: bytes (a and b read once, h written once: 12 bytes
// and one FMA per element).  A lane's S steps stay one dependent chain
// with one rounding per step, which is what keeps the result bit-equal,
// so the design works on the data movement only: a chain of 4,096 FMAs
// takes ~9 us, the bytes of the prefill ~60 us.
//
// Design: one warp per block, one lane tile of 32 lanes of one batch row
// (B * ceil(W / 32) blocks: 128 at the hybrid's prefill, so every SM holds
// a chain), the carry h in a register.  a and b reach the warp through a
// ring of STAGES stages in shared memory, each a tile of TS steps x 32
// lanes of a and of b, filled STAGES - 1 tiles ahead of the scan:
// * TMA path (W % 4 == 0 and a, b 16-byte aligned, so every row of the
//   (B, S, W) tensor starts on 16 bytes): lane 0 issues one 3-D TMA box
//   per array and stage, completion on the stage's mbarrier; the box is
//   zero-filled past S and past W, so nothing is padded in memory;
// * cp.async path (any other W or alignment): each lane copies its own
//   column of the tile with 4-byte cp.async (zero-filled out of bounds),
//   one commit group per stage; a lane reads only what it copied, so it
//   waits on its own groups and no barrier is needed.
// The host picks the path (kernels/rglru_scan.py:copy_path).  The scan
// reads UNROLL steps of a and b from shared memory into registers before
// their FMAs, so only the FMA is on the chain.  On the TMA path h is
// staged in one of two tiles in shared memory and written back by a TMA
// store (clipped at S and W) while the next tile is scanned; on the
// cp.async path each step is one coalesced 128-byte store per warp.  The
// carry after step S - 1 is h[:, S - 1], which the wrapper returns as
// h_last, so it is not written twice.  32 steps per tile, 8 stages and
// the TMA store were the fastest at the prefill (PERF.md §6).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int LANES = 32;              // lanes per block: one warp
constexpr int TS = 32;                 // steps per stage tile
constexpr int STAGES = 8;              // tiles in the ring
constexpr int UNROLL = 8;              // steps read ahead of their FMAs
constexpr int TILE = TS * LANES;       // floats of one array's stage tile
constexpr int OUT_BUFS = 2;            // h tiles of the TMA store
constexpr int SMEM_BYTES =
    (2 * STAGES + OUT_BUFS) * TILE * 4 + STAGES * 8 + 128;  // + alignment
static_assert(TS % UNROLL == 0 && TS <= 256, "TMA boxes hold <= 256 steps");

// scan ``steps`` steps of one stage tile (A, Bt point at this lane's
// column, stride LANES), storing h_t at o[j * stride]
__device__ __forceinline__ float scan_tile(const float* A, const float* Bt,
                                           int steps, float h, float* o,
                                           long stride, bool live) {
  if (steps == TS) {
#pragma unroll 1
    for (int j0 = 0; j0 < TS; j0 += UNROLL) {
      float av[UNROLL], bv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        av[u] = A[(j0 + u) * LANES];
        bv[u] = Bt[(j0 + u) * LANES];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        h = __fmaf_rn(av[u], h, bv[u]);
        if (live) o[(j0 + u) * stride] = h;
      }
    }
  } else {
    for (int j = 0; j < steps; ++j) {
      h = __fmaf_rn(A[j * LANES], h, Bt[j * LANES]);
      if (live) o[j * stride] = h;
    }
  }
  return h;
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
    rglru_scan_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap th,
                      const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ h0, int S, int W, int n_tiles,
                      float* __restrict__ h_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((128 - (acopy::smem_u32(smem_raw) & 127)) & 127);
  float* ring = reinterpret_cast<float*>(base);  // stage s: a, then b
  float* outs = ring + 2 * STAGES * TILE;        // TMA store buffers
  uint64_t* bars = reinterpret_cast<uint64_t*>(outs + OUT_BUFS * TILE);

  const int lane = threadIdx.x;
  const int row = blockIdx.x / n_tiles;
  const int w0 = blockIdx.x % n_tiles * LANES;
  const int w = w0 + lane;
  const bool live = w < W;
  const int n = (S + TS - 1) / TS;
  const long rbase = (long)row * S * W;

  // tile i into stage i % STAGES
  auto issue = [&](int i) {
    float* A = ring + 2 * (i % STAGES) * TILE;
    if (TMA) {
      uint64_t* bar = &bars[i % STAGES];
      acopy::mbar_expect_tx(bar, 2 * TILE * 4);
      acopy::tma_load_3d(A, &ta, bar, w0, i * TS, row);
      acopy::tma_load_3d(A + TILE, &tb, bar, w0, i * TS, row);
    } else {
      if (i < n) {
        A += lane;
        for (int j = 0; j < TS; ++j) {
          const int t = i * TS + j;
          const bool ok = live && t < S;
          const long off = ok ? rbase + (long)t * W + w : 0;
          acopy::cp_async4(A + j * LANES, a + off, ok ? 4 : 0);
          acopy::cp_async4(A + TILE + j * LANES, b + off, ok ? 4 : 0);
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

  float h = live ? h0[(long)row * W + w] : 0.f;
  float* o = h_out + rbase + w;
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    if (TMA)
      acopy::mbar_wait(&bars[s], (i / STAGES) & 1);
    else
      acopy::cp_async_wait<STAGES - 1>();
    const float* A = ring + 2 * s * TILE + lane;
    const int steps = min(TS, S - i * TS);
    if (TMA) {
      // h staged in one of two tiles, written back by a TMA store (clipped
      // at S and W) while the next tile is scanned
      float* so = outs + (i & 1) * TILE;
      if (i >= 2) {
        if (lane == 0)
          asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        __syncwarp();
      }
      h = scan_tile(A, A + TILE, steps, h, so + lane, LANES, true);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        tma_store_3d(&th, so, w0, i * TS, row);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    } else {
      h = scan_tile(A, A + TILE, steps, h, o, W, live);
    }
    o += (long)TS * W;
    __syncwarp();  // every lane has read stage s before it is refilled
    if (!TMA)
      issue(i + STAGES);
    else if (lane == 0 && i + STAGES < n)
      issue(i + STAGES);
  }
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
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& th,
           const float* a, const float* b, const float* h0, int S, int W,
           int n_tiles, long blocks, float* h_out, cudaStream_t stream) {
  auto kern = rglru_scan_kernel<TMA>;
  static const int e = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e) return e;
  kern<<<(unsigned)blocks, LANES, SMEM_BYTES, stream>>>(
      ta, tb, th, a, b, h0, S, W, n_tiles, h_out);
  return (int)cudaGetLastError();
}

}  // namespace

// tma != 0 takes the TMA path; the wrapper sets it only where W % 4 == 0
// and a, b and h_out are 16-byte aligned
extern "C" int rglru_scan_launch(const float* a, const float* b,
                                 const float* h0, int B, int S, int W,
                                 int tma, float* h_out, void* stream) {
  const int n_tiles = (W + LANES - 1) / LANES;
  const long blocks = (long)B * n_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap ta{}, tb{}, th{};
  cudaStream_t st = (cudaStream_t)stream;
  if (!tma)
    return launch<false>(ta, tb, th, a, b, h0, S, W, n_tiles, blocks, h_out,
                         st);
  EncodeTiled fn = acopy::encoder();
  if (fn == nullptr) return acopy::ERR_NO_ENCODER;
  int err = encode(fn, &ta, a, B, S, W);
  if (!err) err = encode(fn, &tb, b, B, S, W);
  if (!err) err = encode(fn, &th, h_out, B, S, W);
  if (err) return err;
  return launch<true>(ta, tb, th, a, b, h0, S, W, n_tiles, blocks, h_out,
                      st);
}
