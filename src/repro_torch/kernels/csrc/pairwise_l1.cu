// pairwise_l1: the (B1, B2) all-pairs L1 distance matrix of x (B1, d) and
// y (B2, d), float32.
//
// Replaces the Pallas TPU kernel repro/kernels/pairwise_l1.py:pairwise_l1.
// Summation order.  The reference reads the feature axis in blocks of
// bd = min(block_d, d) columns (the last block zero-padded to bd), reduces
// each block on its own in the fixed window-32 order of l1_topk2.cuh, and
// adds the block sums in order into a zeroed output.  Inside a block the
// windows of 32 start at column -lo0 (lo0 = ((-bd) % 32) / 2 when bd > 32,
// else 0); each window is summed from 0.f in column order, and the window
// sums fold in window order through the levels that
// kernels/l1_topk2.py:window_plan gives (L1Plan).  This kernel takes the
// same order.  Build with -fmad=false: |x - y| is one f32 subtraction and
// the absolute value a free operand of the add, every add one rounding,
// and there are no float atomics, so the result is bit-equal to the plain
// PyTorch version (repro_torch.kernels.pairwise_l1.pairwise_l1_plain).
//
// Bound on the H100: operations.  Each of the B1*B2*d terms is two FADDs
// (the subtraction, and the add with the absolute value as a modifier);
// the inputs are read from device memory once and the output written
// once, far below the FP32 pipes' time at large B1, B2.
//
// Design: register tiles of the SGEMM kind.  A block of 16 x 16 threads
// computes a BM x BN output tile, each thread the rows ty + 16 i and the
// columns tx + 16 j of it ((BM/16) x (BN/16) outputs).  The block walks
// its windows of 32 columns (the feature blocks' windows one after the
// other) through a ring of PW_STAGES stages in shared memory, each the
// tile's x rows and y rows, 32 floats (128 bytes) a row, the row's eight
// 16-byte chunks stored at chunk ^ (row & 7), so that eight consecutive
// rows' copies of one chunk fall in 32 distinct banks.  A column outside
// [0, len) of the window's feature block, or a row past B1 or B2, is
// staged as zero.  Two ways fill a stage (kernels/pairwise_l1.py:
// copy_path picks one per call):
//   * 16-byte cp.async where every chunk is either inside or outside the
//     block (d, bd and lo0 multiples of 4, x and y on 16 bytes): a thread
//     copies one chunk of BM/32 x rows and BN/32 y rows, zero-filled by
//     src size 0;
//   * 4-byte cp.async otherwise: a warp copies a row's 32 columns.
// Per chunk of 4 staged columns a thread loads its x rows' chunks (one
// 16-byte load each), then per y row its chunk, and adds 4 terms into
// each output's chain in column order: 2 * 4 FADDs per output and 16-byte
// load, and no index arithmetic per term.  The window bookkeeping runs
// once per window, where each chain folds into its block sum.  Only the
// chunks that hold columns of the block are summed (every other staged
// value is +0, and adding |0 - 0| = +0 to a chain that starts at +0.f is
// exact; the last block's windows past its columns are skipped too).  One
// __syncthreads per window orders a stage's reads before its refill.
// Instances (pairwise_l1.py:tile_plan picks one per call):
//   128 x 128, 8 x 8 outputs per thread, one fold sum per output: grids
//     that fill the card;
//   64 x 64 and 32 x 32 (4 x 4, 2 x 2): smaller grids, such as the
//     forecaster's 256 x 256;
//   64 x 64 with the three-level fold of l1_topk2.cuh (L1Fold, MULTI):
//     bd > 1,024, where a block has more than 32 windows.
// A block sum of a d that spans several feature blocks is added into the
// output in block order by the thread that owns the output.  No split of
// the feature axis across blocks: each output keeps its one chain.
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "l1_topk2.cuh"

namespace {

constexpr int PW_THREADS = 256;  // 16 x 16
constexpr int PW_STAGES = 4;     // ring stages: three windows in flight

// floats of one stage: x (BM rows) then y (BN rows), 32 columns each
template <int BM, int BN>
__host__ __device__ constexpr int stage_floats() {
  return L1_WIN * (BM + BN);
}

template <int BM, int BN>
constexpr int smem_bytes() {
  return PW_STAGES * stage_floats<BM, BN>() * 4;
}

// the staged position of column 4 c of row m
__device__ __forceinline__ int swz(int m, int c) {
  return m * L1_WIN + ((c ^ (m & 7)) << 2);
}

__device__ __forceinline__ void lds4(float* r, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
}

// One operand's R rows of a tile (rows row0 + [0, R)) as the copies take
// them.  16-byte path: thread t copies chunk t & 7 of rows (t >> 3) + 32 r;
// each row's pointer is set once (a row past the operand's end reads row 0
// with size 0), so per window only the column moves.  4-byte path: warp w
// copies rows w + 8 r, lane l column l.
template <int R>
struct TileRows {
  const float* row[R / 32];
  const float* a;
  unsigned live;  // bit r: row (t >> 3) + 32 r exists
  int rows, row0, d;

  __device__ TileRows(const float* __restrict__ a_, int rows_, int row0_,
                      int d_)
      : a(a_), live(0), rows(rows_), row0(row0_), d(d_) {
#pragma unroll
    for (int r = 0; r < R / 32; ++r) {
      const int i = row0 + (int)(threadIdx.x >> 3) + 32 * r;
      live |= (i < rows ? 1u : 0u) << r;
      row[r] = a + (long)(i < rows ? i : 0) * d;
    }
  }

  // block-relative columns c0 + [0, 32) of the feature block at column
  // col into dst, zero outside [0, len) (c0 and len multiples of 4)
  __device__ __forceinline__ void copy16(float* dst, long col, int c0,
                                         int len) const {
    const int c = threadIdx.x & 7, m = threadIdx.x >> 3;
    const int k = c0 + 4 * c;
    const bool ok = k >= 0 && k < len;
#pragma unroll
    for (int r = 0; r < R / 32; ++r)
      acopy::cp_async16(dst + swz(m + 32 * r, c),
                        row[r] + col + (ok ? k : 0),
                        ok && (live >> r & 1) ? 16 : 0);
  }

  __device__ __forceinline__ void copy4(float* dst, long col, int c0,
                                        int len) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int k = c0 + lane;
    const bool ok = k >= 0 && k < len;
#pragma unroll 4
    for (int r = 0; r < R / 8; ++r) {
      const int m = warp + 8 * r, i = row0 + m;
      const bool on = ok && i < rows;
      acopy::cp_async4(dst + swz(m, lane >> 2) + (lane & 3),
                       a + (on ? (long)i * d + col + k : 0), on ? 4 : 0);
    }
  }
};

template <int BM, int BN, bool MULTI>
__global__ void __launch_bounds__(PW_THREADS)
    pairwise_l1_kernel(const float* __restrict__ x,
                       const float* __restrict__ y, int B1, int B2, int d,
                       int bd, L1Plan p, int vec, float* __restrict__ out) {
  constexpr int TM = BM / 16, TN = BN / 16;
  extern __shared__ __align__(128) float smem[];
  const int ntc = (B2 + BN - 1) / BN;
  const int row0 = (int)(blockIdx.x / ntc) * BM;
  const int col0 = (int)(blockIdx.x % ntc) * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const int nb = (d + bd - 1) / bd;                     // feature blocks
  const int nv = (bd + p.lo0 + L1_WIN - 1) / L1_WIN;    // windows of one
  const int last_len = d - (nb - 1) * bd;
  const int nq = (nb - 1) * nv + (last_len + p.lo0 + L1_WIN - 1) / L1_WIN;

  const TileRows<BM> xr(x, B1, row0, d);
  const TileRows<BN> yr(y, B2, col0, d);
  // stage window q: block-relative columns 32 v - lo0 + [0, 32) of
  // feature block b
  auto issue = [&](int q) {
    const int b = q / nv, v = q - b * nv;
    const int len = min(bd, d - b * bd), c0 = v * L1_WIN - p.lo0;
    float* st = smem + (q % PW_STAGES) * stage_floats<BM, BN>();
    if (vec) {
      xr.copy16(st, (long)b * bd, c0, len);
      yr.copy16(st + L1_WIN * BM, (long)b * bd, c0, len);
    } else {
      xr.copy4(st, (long)b * bd, c0, len);
      yr.copy4(st + L1_WIN * BM, (long)b * bd, c0, len);
    }
  };
#pragma unroll
  for (int s = 0; s < PW_STAGES - 1; ++s) {
    if (s < nq) issue(s);
    acopy::cp_async_commit();
  }

  // per output: the open window's chain, and its block's fold (one sum,
  // or the three levels of L1Fold)
  float acc[TM][TN], fold[MULTI ? 1 : TM][MULTI ? 1 : TN];
  L1Fold lf[MULTI ? TM : 1][MULTI ? TN : 1];
  if constexpr (!MULTI) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) fold[i][j] = 0.f;
  }

  for (int q = 0; q < nq; ++q) {
    const int b = q / nv, v = q - b * nv;
    const int len = min(bd, d - b * bd);
    const int c0 = v * L1_WIN - p.lo0;
    acopy::cp_async_wait<PW_STAGES - 2>();
    __syncthreads();  // stage q is in; every thread is done with q - 1's
    if (q + PW_STAGES - 1 < nq) issue(q + PW_STAGES - 1);
    acopy::cp_async_commit();

    // this thread's rows: x row ty + 16 i, y row tx + 16 j; the rows of
    // one thread share row & 7
    const float* xs = smem + (q % PW_STAGES) * stage_floats<BM, BN>() +
                      ty * L1_WIN;
    const float* ys = xs - ty * L1_WIN + L1_WIN * BM + tx * L1_WIN;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    // the chunks that hold columns of the block
    const int clo = max(0, -c0) >> 2;
    const int chi = (min(L1_WIN, len - c0) + 3) >> 2;
#pragma unroll 1
    for (int c = clo; c < chi; ++c) {
      const int ox = (c ^ (ty & 7)) << 2, oy = (c ^ (tx & 7)) << 2;
      float xv[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) lds4(xv[i], xs + 16 * L1_WIN * i + ox);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float yv[4];
        lds4(yv, ys + 16 * L1_WIN * j + oy);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j] = acc[i][j] + fabsf(xv[i][e] - yv[e]);
      }
    }

    // the window's chains fold into the block sums
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if constexpr (MULTI)
          lf[i][j].add(p, v, acc[i][j]);
        else
          fold[i][j] = fold[i][j] + acc[i][j];
      }
    if (q != nq - 1 && v != nv - 1) continue;
    // the end of feature block b: its sums are added into the output
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float bs;
        if constexpr (MULTI) {
          bs = lf[i][j].finish(p);
          lf[i][j] = L1Fold();
        } else {
          bs = fold[i][j];
          fold[i][j] = 0.f;
        }
        const int cc = col0 + tx + 16 * j;
        if (r < B1 && cc < B2) {
          float* o = out + (long)r * B2 + cc;
          *o = (b == 0 ? 0.f : *o) + bs;
        }
      }
    }
  }
}

template <int BM, int BN, bool MULTI>
int launch(const float* x, const float* y, int B1, int B2, int d, int bd,
           const L1Plan& p, int vec, float* out, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BM, BN>();
  static const int e = (int)cudaFuncSetAttribute(
      pairwise_l1_kernel<BM, BN, MULTI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  const long tiles = (long)((B1 + BM - 1) / BM) * ((B2 + BN - 1) / BN);
  if (tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  pairwise_l1_kernel<BM, BN, MULTI>
      <<<(unsigned)tiles, PW_THREADS, smem, stream>>>(x, y, B1, B2, d, bd, p,
                                                      vec, out);
  return (int)cudaGetLastError();
}

}  // namespace

// plan: kernels/l1_topk2.py:window_plan(bd); tile: the output tile edge
// (kernels/pairwise_l1.py:tile_plan): 128, 64 or 32, and 64 when plan
// has two or more window levels; vec: 1 for the 16-byte copies
// (kernels/pairwise_l1.py:copy_path), else 0.
extern "C" int pairwise_l1_launch(const float* x, const float* y, int B1,
                                  int B2, int d, int bd, const int* plan,
                                  int tile, int vec, float* out,
                                  void* stream) {
  const L1Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  cudaStream_t s = (cudaStream_t)stream;
  if (p.nwin >= 2)
    return tile == 64
               ? launch<64, 64, true>(x, y, B1, B2, d, bd, p, vec, out, s)
               : (int)cudaErrorInvalidValue;
  switch (tile) {
    case 128:
      return launch<128, 128, false>(x, y, B1, B2, d, bd, p, vec, out, s);
    case 64:
      return launch<64, 64, false>(x, y, B1, B2, d, bd, p, vec, out, s);
    case 32:
      return launch<32, 32, false>(x, y, B1, B2, d, bd, p, vec, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
