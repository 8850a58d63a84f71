// centroid_update: c_j <- (w * c_j + sum_{i: a_i = j} x_i) / (w + n_j).
//
// Replaces the Pallas TPU kernel repro/kernels/centroid_update.py:
// centroid_update (a one-hot matmul on the MXU).
// Bound on the H100: memory.  It reads c (k*d), the assigned rows of x and
// assign once and writes k*d floats, at under one flop per byte.
//
// Summation order: the reference's (kernels/centroid_update.py:row_blocks):
// the rows, padded to a multiple of 8, split into P = ceil(N / 608) parts
// of 8 * ceil(N / 8P) rows (the last takes the rest), a part longer than
// 384 rows into two halves (with one cluster, one block of all rows); each
// block sums a cluster's rows in row order from zero and the block sums
// are added in order.  Rows whose assignment is < 0 or >= k are ignored,
// so the fleet caller needs no one-hot.  Built with -fmad=false; the
// reference's one fused multiply-add (w * c_j + sum) is written out as
// __fmaf_rn, and the division stays an IEEE division.
// No float atomics: the result is bit-equal to the plain PyTorch version.
//
// Design: one pass over the assigned rows.  One block per tile of 32
// columns (one lane per column) with E_WARPS warps.  The block sorts the
// assigned rows of a chunk of E_CHUNK rows by cluster, in row order within
// each cluster, into a list in shared memory: the chunk's assignments are
// staged once; each warp counts its share of the rows per cluster
// (__match_any_sync, integers), warp 0 turns the counts into each
// cluster's start and each warp's offsets (a shuffle scan over the
// clusters), and each warp scatters its rows in order.  A
// cluster's rows are then one segment of the list, walked by one warp
// (cluster j by warp j % E_WARPS, so E_WARPS clusters are summed at once):
// each lane keeps the cluster's running sum and the open row block's sum
// in registers and folds the block sum where a row crosses into a new
// block, as the reference adds its block sums.  Across chunks the sums
// wait in shared memory.  x reaches the walk through a ring of E_STAGES
// stages of E_STAGE_ROWS rows per warp that each lane fills for its own
// column with 4-byte cp.async; a lane reads only what it copied, so it
// waits on its own commit groups and no barrier is needed.  Each stage's
// row indices and values are read into registers before the stage's adds,
// so only the add chain is serial.  x is read once, and only its assigned
// rows.  8 warps and 8 stages of 8 rows were the fastest of the layouts
// measured (PERF.md §6).
//
// Over a mesh of several blocks (a shared bank served by a fleet cut into
// blocks) the reference sums each block's rows locally and adds the
// blocks' partial sums and counts in block order before the finish, so
// the kernel has two more entries: centroid_partial_launch (the same walk
// over one block's rows; it writes the sums and the f32 counts, no
// finish) and centroid_finish_launch (the summed partials' finish,
// (w * c + sum) / (w + n), one thread per element).  The partials are
// summed between them in block order on the first block's device.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int E_WARPS = 8;         // warps per block: clusters walked at once
constexpr int E_THREADS = 32 * E_WARPS;
constexpr int E_STAGES = 8;        // ring stages per warp
constexpr int E_STAGE_ROWS = 8;    // rows of x per stage
constexpr int E_CHUNK = 2048;      // rows sorted per pass
constexpr int E_MAX_K = 128;       // clusters the shared memory holds
constexpr int PART_ROWS = 608;     // the reference's split (row_blocks)
constexpr int BLOCK_ROWS = 384;
constexpr int RING = E_WARPS * E_STAGES * E_STAGE_ROWS * 32;  // floats

// shared memory: the rings, the chunk's assignments and sorted list, per
// (warp, cluster) a count and a cursor, per cluster the chunk's count, its
// start in the list and its total, and per (cluster, lane) the running
// sum, the open block's sum and the open block's end
constexpr int smem_bytes(int k) {
  return (RING + 2 * E_CHUNK + 2 * E_WARPS * k + 3 * k + 3 * 32 * k) * 4;
}

// the end of the reference's row block that holds ``row``
__device__ __forceinline__ int block_end(int row, int n8, int n_parts,
                                         int part) {
  const int p = min(row / part, n_parts - 1);
  const int start = p * part;
  const int size = p + 1 < n_parts ? part : n8 - start;
  if (size > BLOCK_ROWS) {
    const int half = size / 2;
    return row < start + half ? start + half : start + size;
  }
  return start + size;
}

// PARTIAL: out takes the sums and cnt the counts (c and w unused)
template <bool PARTIAL>
__global__ void __launch_bounds__(E_THREADS)
    centroid_update_kernel(const float* __restrict__ c,
                           const float* __restrict__ x,
                           const int* __restrict__ assign, int B, int k,
                           int d, float w, float* __restrict__ out,
                           float* __restrict__ cnt) {
  extern __shared__ __align__(16) float smem[];
  int* asg = reinterpret_cast<int*>(smem + RING);
  int* list = asg + E_CHUNK;
  int* wcnt = list + E_CHUNK;         // [E_WARPS][k]
  int* wcur = wcnt + E_WARPS * k;     // [E_WARPS][k]
  int* ctot = wcur + E_WARPS * k;
  int* start = ctot + k;
  int* total = start + k;
  float* run_s = reinterpret_cast<float*>(total + k);  // [k][32]
  float* run_b = run_s + 32 * k;
  int* run_e = reinterpret_cast<int*>(run_b + 32 * k);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int f = blockIdx.x * 32 + lane;
  const bool live = f < d;
  const float c_first =
      !PARTIAL && warp < k && live ? c[(long)warp * d + f] : 0.f;
  float* ring = smem + warp * E_STAGES * E_STAGE_ROWS * 32 + lane;
  const int n8 = (B + 7) / 8 * 8;
  const int n_parts = (n8 + PART_ROWS - 1) / PART_ROWS;
  const int part = 8 * ((n8 + 8 * n_parts - 1) / (8 * n_parts));

  for (int j = tid; j < k; j += E_THREADS) total[j] = 0;
  for (int i = tid; i < 3 * 32 * k; i += E_THREADS)  // run_s, run_b, run_e
    reinterpret_cast<int*>(run_s)[i] = 0;

  for (int c0 = 0; c0 < B; c0 += E_CHUNK) {
    const int nc = min(E_CHUNK, B - c0);
#pragma unroll 4
    for (int r = tid; r < nc; r += E_THREADS) asg[r] = assign[c0 + r];
    for (int i = tid; i < E_WARPS * k; i += E_THREADS) wcnt[i] = 0;
    __syncthreads();
    // each warp's share of the chunk, whole rounds of 32 rows
    const int rw = (nc + 32 * E_WARPS - 1) / (32 * E_WARPS) * 32;
    const int r_lo = warp * rw, r_hi = min(nc, r_lo + rw);
    for (int r0 = r_lo; r0 < r_hi; r0 += 32) {
      const int j = r0 + lane < r_hi ? asg[r0 + lane] : -1;
      const bool ok = j >= 0 && j < k;
      const unsigned peers = __match_any_sync(0xffffffffu, ok ? j : -1);
      if (ok && !(peers & below)) wcnt[warp * k + j] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    if (warp == 0) {  // each cluster's start, and each warp's offset in it
      int carry = 0;
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int j = j0 + lane;
        int n = 0;
        if (j < k)
#pragma unroll
          for (int ww = 0; ww < E_WARPS; ++ww) n += wcnt[ww * k + j];
        int incl = n;  // inclusive scan over the lanes
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        if (j < k) {
          int acc = carry + incl - n;
          start[j] = acc;
          ctot[j] = n;
          total[j] += n;  // integers: exact
#pragma unroll
          for (int ww = 0; ww < E_WARPS; ++ww) {
            wcur[ww * k + j] = acc;
            acc += wcnt[ww * k + j];
          }
        }
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
    __syncthreads();
    for (int r0 = r_lo; r0 < r_hi; r0 += 32) {  // stable scatter
      const int j = r0 + lane < r_hi ? asg[r0 + lane] : -1;
      const bool ok = j >= 0 && j < k;
      const unsigned peers = __match_any_sync(0xffffffffu, ok ? j : -1);
      if (ok)
        list[wcur[warp * k + j] + __popc(peers & below)] = c0 + r0 + lane;
      __syncwarp();
      if (ok && !(peers & below)) wcur[warp * k + j] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();

    for (int j = warp; j < k; j += E_WARPS) {
      const int e_lo = start[j], e_hi = e_lo + ctot[j];
      if (e_lo == e_hi) continue;
      float s = run_s[32 * j + lane], blk = run_b[32 * j + lane];
      int be = run_e[32 * j + lane];
      // stage q: x at the list's rows e_lo + q * E_STAGE_ROWS + u.  A
      // stage's list entries are read together, up to E_STAGE_ROWS - 1
      // past the list's end (into the counts behind it, never used)
      auto issue = [&](int q) {
        float* dst = ring + q % E_STAGES * E_STAGE_ROWS * 32;
        const int e0 = e_lo + q * E_STAGE_ROWS;
        const int m = e_hi - e0;
        if (live && m > 0) {
          int rows[E_STAGE_ROWS];
#pragma unroll
          for (int u = 0; u < E_STAGE_ROWS; ++u) rows[u] = list[e0 + u];
#pragma unroll
          for (int u = 0; u < E_STAGE_ROWS; ++u)
            if (u < m)
              acopy::cp_async4(dst + 32 * u, x + (long)rows[u] * d + f, 4);
        }
        acopy::cp_async_commit();  // empty past the end: counts stay uniform
      };
      for (int q = 0; q < E_STAGES; ++q) issue(q);
      const int n_q = (e_hi - e_lo + E_STAGE_ROWS - 1) / E_STAGE_ROWS;
      for (int q = 0; q < n_q; ++q) {
        acopy::cp_async_wait<E_STAGES - 1>();
        const float* v = ring + q % E_STAGES * E_STAGE_ROWS * 32;
        const int e0 = e_lo + q * E_STAGE_ROWS;
        const int m = e_hi - e0;
        int rows[E_STAGE_ROWS];
        float vals[E_STAGE_ROWS];
#pragma unroll
        for (int u = 0; u < E_STAGE_ROWS; ++u) {
          rows[u] = list[e0 + u];
          vals[u] = v[32 * u];
        }
#pragma unroll
        for (int u = 0; u < E_STAGE_ROWS; ++u) {
          if (u < m) {
            if (rows[u] >= be) {  // a new row block: fold the finished one
              s = __fadd_rn(s, blk);
              blk = 0.f;
              be = k == 1 ? n8 : block_end(rows[u], n8, n_parts, part);
            }
            blk = __fadd_rn(blk, vals[u]);
          }
        }
        issue(q + E_STAGES);
      }
      acopy::cp_async_wait<0>();
      run_s[32 * j + lane] = s;
      run_b[32 * j + lane] = blk;
      run_e[32 * j + lane] = be;
    }
    if (c0 + E_CHUNK < B) __syncthreads();  // the next chunk rewrites them
  }

  if (PARTIAL && blockIdx.x == 0) {
    __syncthreads();  // the last chunk's totals
    for (int j = tid; j < k; j += E_THREADS) cnt[j] = (float)total[j];
  }
  if (!live) return;
  for (int j = warp; j < k; j += E_WARPS) {
    const float s = __fadd_rn(run_s[32 * j + lane], run_b[32 * j + lane]);
    const long o = (long)j * d + f;
    if (PARTIAL) {
      out[o] = s;
      continue;
    }
    const float cj = j == warp ? c_first : c[o];
    out[o] = __fdiv_rn(__fmaf_rn(w, cj, s), __fadd_rn(w, (float)total[j]));
  }
}

// the finish of summed partials: out = (w * c + sums) / (w + counts)
__global__ void centroid_finish_kernel(const float* __restrict__ c,
                                       const float* __restrict__ sums,
                                       const float* __restrict__ counts,
                                       long n, int d, float w,
                                       float* __restrict__ out) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x)
    out[i] = __fdiv_rn(__fmaf_rn(w, c[i], sums[i]),
                       __fadd_rn(w, counts[i / d]));
}

template <bool PARTIAL>
int launch_walk(const float* c, const float* x, const int* assign, int B,
                int k, int d, float w, float* out, float* cnt,
                cudaStream_t stream) {
  if (k < 1 || k > E_MAX_K) return (int)cudaErrorInvalidValue;
  static const int e = (int)cudaFuncSetAttribute(
      centroid_update_kernel<PARTIAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(E_MAX_K));
  if (e) return e;
  const int blocks = (int)(((long)d + 31) / 32);
  centroid_update_kernel<PARTIAL><<<blocks, E_THREADS, smem_bytes(k),
                                    stream>>>(c, x, assign, B, k, d, w, out,
                                              cnt);
  return (int)cudaGetLastError();
}

}  // namespace

// k <= E_MAX_K (the wrapper checks); B rows of x and assign, d columns
extern "C" int centroid_update_launch(const float* c, const float* x,
                                      const int* assign, int B, int k, int d,
                                      float w, float* out, void* stream) {
  return launch_walk<false>(c, x, assign, B, k, d, w, out, nullptr,
                            (cudaStream_t)stream);
}

// one block's partial sums (k, d) and f32 counts (k,) of its B rows
extern "C" int centroid_partial_launch(const float* x, const int* assign,
                                       int B, int k, int d, float* sums,
                                       float* counts, void* stream) {
  return launch_walk<true>(nullptr, x, assign, B, k, d, 0.f, sums, counts,
                           (cudaStream_t)stream);
}

// the finish of the summed partials of every block
extern "C" int centroid_finish_launch(const float* c, const float* sums,
                                      const float* counts, int k, int d,
                                      float w, float* out, void* stream) {
  const long n = (long)k * d;
  const int threads = 256;
  const int blocks = (int)std::min<long>((n + threads - 1) / threads, 4096);
  centroid_finish_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      c, sums, counts, n, d, w, out);
  return (int)cudaGetLastError();
}
