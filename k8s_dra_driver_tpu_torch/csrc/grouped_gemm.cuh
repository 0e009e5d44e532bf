// The warp-specialised grouped GEMM pieces shared by the grouped matrix
// products (grouped_matmul.cu: K10a gmm, K10b tgmm; grouped_matmul_int8.cu:
// A7b) and the fused MoE dispatch kernels' wide body (moe_dispatch.cu: K7,
// K8 at row tiles above 16): the tile and stage geometry, the ring's depth,
// the raster that keeps the operands the blocks in flight share in L2, one
// stage's wgmma products and the host-side tensor maps over row operands
// and expert stacks.
//
// A block of 3 warpgroups (kWgThreads) owns a 128-row output tile: a
// producer warpgroup fills a ring of 64-deep stages whose operands lie in
// 128-byte swizzled boxes of 64 columns (kBox bytes for 64 rows), and two
// consumer warpgroups run wgmma on them.

#pragma once

#include "hopper.cuh"  // mbarriers, TMA, wgmma, setmaxnreg, tensor maps

namespace {

constexpr int kRowTile = 128;              // output rows of a block
constexpr int kDepth = 64;                 // contracted depth of a stage
constexpr int kBox = kDepth * kRowBytes;   // a 64-row box of 64 columns
constexpr int kSwizzle = 8;                // row (K) tiles per column sweep

// Shared memory (byte offsets from a 1024-aligned base): STAGES stages of A
// (128 x 64: two 8 KB boxes) then B (BN x 64: BN / 64 boxes, or one box of
// BN rows), then the full and empty barriers.
template <int BN>
struct Ring {
  static constexpr int A = kRowTile * kRowBytes;
  static constexpr int STAGE = A + BN * kRowBytes;
  static constexpr int STAGES =
      192 * 1024 / STAGE < 8 ? 192 * 1024 / STAGE : 8;
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int USED = BARS + 2 * STAGES * 8;
  static constexpr int BYTES = USED + 1024 > kMinSmem ? USED + 1024
                                                      : kMinSmem;
};

// Block index -> (row item, column tile): kSwizzle row items per sweep of
// the columns.
__device__ __forceinline__ void swizzle(int pid, int n_rows, int n_cols,
                                        int& row, int& col) {
  const int span = kSwizzle * n_cols;
  const int first = (pid / span) * kSwizzle;
  const int size = min(n_rows - first, kSwizzle);
  row = first + (pid % span) % size;
  col = (pid % span) / size;
}

// The 4 k16 products of one stage into a consumer's 64 x BN accumulators.
// TA / TB: A / B MN-major (transpose bit), else K-major. An MN-major B's
// 64-column blocks lie `lbo` bytes apart.
template <int BN, int TA, int TB>
__device__ __forceinline__ void stage_products(float (&acc)[BN / 2],
                                               uint32_t a, uint32_t b,
                                               uint32_t lbo = kBox) {
#pragma unroll
  for (int kk = 0; kk < kDepth / 16; ++kk) {
    const uint64_t da = TA ? mnmajor_desc(a + kk * 16 * kRowBytes, kBox)
                           : kmajor_desc(a + kk * 32);
    const uint64_t db = TB ? mnmajor_desc(b + kk * 16 * kRowBytes, lbo)
                           : kmajor_desc(b + kk * 32);
    if constexpr (BN == 256)
      wgmma_ss_n256<TA, TB>(acc, da, db, 1);
    else if constexpr (BN == 128)
      wgmma_ss_n128<TA, TB>(acc, da, db, 1);
    else
      wgmma_ss_n64<TA, TB>(acc, da, db, 1);
  }
}

// A rank-2 map over a row-major [outer, inner] bf16 matrix in boxes of 64
// columns x `box_rows` rows.
int matrix_map(CUtensorMap* map, const void* base, int outer, int inner,
               int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return bf16_tensor_map(map, base, 2, dims, strides, box);
}

// A rank-3 map over [E, outer, inner] bf16 in boxes of 64 x `box_rows` x 1;
// `row_stride` / `e_stride` (elements, 0: packed) place the rows and the
// experts of a strided view (a tensor shard's block of a whole stack).
int experts_map(CUtensorMap* map, const void* base, int e, int outer,
                int inner, int box_rows, long long row_stride = 0,
                long long e_stride = 0) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(e)};
  const long long rs = row_stride ? row_stride : inner;
  const long long es = e_stride ? e_stride : (long long)outer * rs;
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(rs) * 2,
                                 static_cast<cuuint64_t>(es) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return bf16_tensor_map(map, base, 3, dims, strides, box);
}

// A rank-3 map over [E, outer, inner] int8 in boxes of `box_cols` x 64 x
// 1 (64 rows of `box_cols` bytes): unswizzled, or (swizzled, box_cols 128)
// with the 16-byte chunks of row k permuted by chunk ^ (k & 7).
int int8_experts_map(CUtensorMap* map, const void* base, int e, int outer,
                     int inner, int box_cols, bool swizzled = false) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(e)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner),
                                 static_cast<cuuint64_t>(outer) * inner};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), kDepth, 1};
  if (swizzled)
    return tensor_map_of(map, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                         CU_TENSOR_MAP_SWIZZLE_128B, base, 3, dims, strides,
                         box);
  return int8_tensor_map(map, base, 3, dims, strides, box);
}

}  // namespace
