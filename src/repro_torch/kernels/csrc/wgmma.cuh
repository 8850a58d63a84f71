// Tensor-core helpers shared by kernel G's forward (flash_attn.cu) and its
// backward (flash_attn_bwd.cu): 4-D TMA loads of bf16 tiles with 128-byte
// swizzle, wgmma shared-memory descriptors, the wgmma fences, and the
// m64n64k16 bf16 products with f32 accumulators (A from registers or from
// shared memory), and the host's encoding of a (d3, d2, d1, hd) bf16 tensor
// as a TMA map.
//
// A tile in shared memory is stored as column blocks of 64 bf16 (one
// 128-byte row per tile row), each block [rows][128 bytes], 16-byte chunk
// c of row r at chunk c ^ (r & 7): the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1,024-byte aligned buffer, and the one
// the descriptors below describe.
#pragma once
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace tc {

constexpr int ROW_BYTES = 128;  // 64 bf16: one swizzled row of a tile block

// a 4-D TMA box (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(
          acopy::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(acopy::smem_u32(bar)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: 128-byte swizzle, byte offsets.  An
// MN-major operand (rows of the tile along K) takes lbo = the stride of
// its 64-column blocks and sbo = 1,024 (8 rows); a K-major one (columns of
// the tile along K) takes sbo = 1,024 and starts 32 bytes further for each
// step of 16 along K inside a column block (lbo unused).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t a = acopy::smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from reading an accumulator before the wait
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_D32_OUT(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64 f32) += a (64 x 16 bf16 in registers) * b (16 x 64,
// MN-major in shared memory)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : WG_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 f32) += a (64 x 16) * b^T for b (64 x 16), both K-major in
// shared memory: a's rows and b's rows (the output's columns) each hold
// their 16 K values contiguously
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : WG_D32_OUT(d)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A 64 x 64 f32 accumulator (the layout of a 64 x 64 wgmma: warp w of the
// warpgroup holds rows 16 w + lane/4 (elements e with e & 2 == 0) and
// 16 w + lane/4 + 8 (e & 2 != 0), at columns 8 (e / 4) + 2 (lane % 4) +
// (e & 1)) rounded to bf16 as the A fragments of four k16 steps over its
// columns: rows r and r + 8, columns 16 kc + 2t (+1) and 16 kc + 8 + 2t
// (+1).  The layouts line up, so this is a packing in place.
__device__ __forceinline__ void acc_to_a(const float (&s)[32],
                                         uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    pa[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
    pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// A bf16 tensor (d3, d2, d1, hd) row-major as a 4-D TMA map whose box is
// 64 columns x b1 x b2 x 1, 128-byte swizzle, zeros out of bounds.
inline int encode(acopy::EncodeTiled fn, CUtensorMap* map, const void* ptr,
                  int hd, int d1, int d2, int d3, int b1, int b2) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)d1, (cuuint64_t)d2,
                              (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)hd * d1 * 2,
                                 (cuuint64_t)hd * d1 * d2 * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)b1, (cuuint32_t)b2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : acopy::ERR_ENCODE + (int)r;
}

}  // namespace tc
