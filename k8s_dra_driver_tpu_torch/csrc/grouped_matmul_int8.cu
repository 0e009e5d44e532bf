// The int8 grouped matrix product for Hopper (sm_90a): the primitive MoE
// path's expert products with int8 weights (models/moe.py
// _dropless_tp_out, on a mesh without an expert axis, through
// ops/moe_dispatch.py::grouped_matmul_int8).
//
// Replaces no Pallas kernel: the reference runs XLA's lax.ragged_dot with
// the int8 rhs kept int8 and the per-channel scale in the epilogue
// (k8s_dra_driver_tpu/ops/moe_dispatch.py::grouped_matmul, its int8
// branch). Computes, with g(r) the group whose rows [start_g, start_g +
// size_g) hold row r:
//
//   out[r, c] = bf16( (sum_k lhs[r, k] * q[g(r), k, c]) * scale[g(r), c] )
//
// with f32 sums; rows at or past sum(group_sizes) are 0. lhs bf16 [rows,
// K] row-major; q int8 and scale f32 addressed through strides, so a
// tensor shard's block of a whole expert stack is read where it lies:
// column c of the output is column c % half_n of half c / half_n (a
// gate/up stack [E, K, 2, M / T] gives the gate half first, half_n = M /
// T; a plain [E, K, N] stack has one half, half_n = N). Each half is read
// through its own rank-3 tensor map [E, K, half_n] on the half's base
// pointer with the view's expert and row strides, so both halves come out
// of one launch with no copy; TMA's zero fill past the map's edges covers
// a K that is no multiple of the 64-deep stage and a half_n that is no
// multiple of the column block (those columns are never stored).
//
// What bounds it on the H100: bytes at decode (the touched experts' int8
// weights, ~29 MB an expert for Mixtral's gate/up at tensor 4, against a
// few dozen rows), operations at prefill (2 x rows x K x N). Two bodies,
// chosen on the host by ops/moe_dispatch.py::int8_gmm_plan from host
// integers alone (never the group sizes):
//
// Narrow (decode: rows <= 64 an expert): the swapped form of the int8
// MoE kernels' decode body (moe_dispatch.cu kSwap, quant_matmul.cu's
// M <= 64 form). The weights' columns are wgmma's M, as register A
// fragments each thread converts straight from the swizzled int8 TMA box
// (int8_image.cuh, swap_fragments), and the group's rows are N (NR = 16,
// 32 or 64, K-major through a rank-2 map over lhs; rows past the group
// are multiplied but never stored).
//   - A block of 160 threads owns one (group, 128 columns of one half):
//     warps 0-3 the consumer warpgroup, warp 4 the producer, one thread of
//     which keeps a TMA ring of 64-deep stages full (int8 box [64 k][128],
//     128-byte swizzle; lhs box [NR rows][64 k]). Two register buffers: a
//     stage converts while the one before multiplies.
//   - Grid (column blocks of both halves, groups + 1), from host integers;
//     a block finds its group's rows by the prefix sum of the sizes (E
//     adds), an empty group's blocks exit at once, and row y = E writes
//     the zeros of the rows past the last group.
//   - A group of more than NR rows is covered by NR-row passes; the ring
//     runs on from pass to pass, and each pass after the first re-reads
//     the block's 128-column strip of the weights, most of it from L2
//     when the group is large (a large group leaves the other groups
//     small, so few strips are in flight).
//   - Four blocks fit an SM at NR 16 (two at 32 and 64): Mixtral's decode
//     gate/up at tensor 4 (56 column blocks a group, up to 8 experts
//     touched: 448 blocks) fits one wave of 528; at three an SM (a 64 KB
//     ring each) it took two and was slower on the H100 (PERF.md).
// Wide (prefill): the warp-specialised wgmma body of int8_matmul
// (quant_matmul.cu), grouped as K10a's gmm (grouped_matmul.cu).
//   - A block of 3 warpgroups owns a (row tile of 128, group) intersection
//     and 256 columns of one half. Warpgroup 0 (setmaxnreg 40): one
//     thread keeps a ring of 4 stages full: the lhs tile [128 rows][64 k]
//     (rank-2 bf16 map over [rows, K], 128-byte swizzle) and the int8 tile
//     [64 k][256] (unswizzled rank-3 map over the half).
//   - Warpgroups 1 and 2 (setmaxnreg 232) own 128 columns each and all
//     128 rows (two m64 halves). Each converts its columns of a landed
//     int8 tile into its own swizzled MN-major bf16 image (int8_image.cuh,
//     three images) while its wgmma products of the two stages before run,
//     then fences the image into the async proxy and meets its own warps at
//     a named barrier.
//   - A row tile that straddles two groups is loaded once per group, each
//     visit multiplying by its group's weights and storing only its
//     group's rows; the items past the intersections write the zeros of
//     the rows past the last group (K10a's walk: at most row tiles + E
//     items, the grid's count; the rest return at once). Blocks walk 8
//     row items per column sweep, so the weight tile the blocks in flight
//     share stays in L2.
// Both bodies issue every product unconditionally and touch the
// accumulators only after the last wait, so ptxas does not serialise
// wgmma; the scale multiplies the f32 sums in the epilogue, one cast.
// No atomics and no split: two calls give the same bits.
//
// Left out, measured no faster on the H100 (PERF.md): the first design, a
// 128-thread wmma body (64 x 64 tiles, the weights converted to bf16 in
// shared memory between two barriers a 128-deep step, one step of loads
// in flight: 27-32% of its bound at decode, 12% at prefill); a wide block
// of 128 columns (slower at every 8x7b and 8x160m shape, faster only
// where a half is at most 128 columns wide); the narrow body at 2 blocks
// an SM with a 100 KB ring, or 1 with 200 KB.

#include "grouped_gemm.cuh"  // kRowTile, kDepth, kBox, swizzle, matrix_map
#include "int8_image.cuh"    // int8 tiles into bf16 images or swapped
                             // register fragments

namespace {

typedef __nv_bfloat16 bf16;

// The scale's strides (elements: expert, half) and the width of a half.
struct Scales {
  long long se, sh;
  int half_n;
};

// Rows [lo, hi) of group g, clamped to the rows.
__device__ __forceinline__ void group_rows(const int32_t* sizes, int g,
                                           int rows, int& lo, int& hi) {
  int start = 0;
  for (int e = 0; e < g; ++e) start += max(sizes[e], 0);
  lo = min(start, rows);
  hi = min(start + max(sizes[g], 0), rows);
}

// Zeros into rows [lo, hi) of output columns [c0, c0 + cols) that lie
// below `limit` (the half's end), 16 bytes a store.
__device__ __forceinline__ void zero_rows(bf16* out, int n, int lo, int hi,
                                          int c0, int cols, int limit,
                                          int threads) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < (hi - lo) * chunks; i += threads) {
    const int r = lo + i / chunks, c = c0 + (i % chunks) * 8;
    if (c < limit)
      *reinterpret_cast<uint4*>(out + (size_t)r * n + c) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// Narrow: the swapped form.
// ---------------------------------------------------------------------------

constexpr int kNarrowCols = 128;               // weight columns of a block
constexpr int kNarrowThreads = 160;            // a consumer warpgroup + a
                                               // producer warp
constexpr int kQBox = kDepth * kNarrowCols;    // int8 box: 64 k x 128

// NR group rows as wgmma's N. Shared memory (byte offsets from a
// 1024-aligned base): STAGES stages of the int8 box then the lhs box (NR
// rows x 64 k, 128-byte swizzle: both start 1024-aligned), then the full
// and empty barriers.
template <int NR>
struct Narrow {
  // Blocks an SM runs at once: four at NR 16 (a 50 KB ring each, at most
  // 96 registers a thread), so Mixtral's decode gate/up at tensor 4 (448
  // blocks when all 8 experts are touched) runs in one wave of 528; two
  // at 32 and 64 rows, whose accumulators take the registers.
  static constexpr int BLOCKS = NR <= 16 ? 4 : 2;
  static constexpr int RING = (NR <= 16 ? 50 : 64) * 1024;
  static constexpr int XBOX = NR * kRowBytes;
  static constexpr int STAGE = kQBox + XBOX;
  static constexpr int STAGES = RING / STAGE < 8 ? RING / STAGE : 8;
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;
  static_assert(STAGES >= 2 && XBOX % 1024 == 0, "ring");
};

// x_map: lhs [rows, K] bf16 in 64 x NR swizzled boxes; q_map[h]: half h
// [E, K, half_n] int8 in 128 x 64 x 1 swizzled boxes. Block (blockIdx.x,
// blockIdx.y): column block blockIdx.x (per_half a half), group blockIdx.y
// (n_groups: the rows past the last group).
template <int NR>
__global__ void __launch_bounds__(kNarrowThreads, Narrow<NR>::BLOCKS)
grouped_matmul_int8_narrow(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap q0_map,
                           const __grid_constant__ CUtensorMap q1_map,
                           const float* __restrict__ scale,
                           const int32_t* __restrict__ sizes,
                           bf16* __restrict__ out, int rows, int k, int n,
                           int n_groups, int per_half, Scales sc_lay) {
  using W = Narrow<NR>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W::BARS);
  uint64_t* empty = full + W::STAGES;

  const int half = blockIdx.x / per_half;
  const int hc0 = (blockIdx.x % per_half) * kNarrowCols;
  const int half_n = sc_lay.half_n;
  bf16* out_h = out + half * half_n;  // this half's first output column
  const int g = blockIdx.y;
  if (g == n_groups) {
    // The rows past the last group: zeros.
    int total, unused;
    group_rows(sizes, n_groups - 1, rows, unused, total);
    zero_rows(out_h, n, total, rows, hc0, kNarrowCols, half_n,
              kNarrowThreads);
    return;
  }
  int lo, hi;
  group_rows(sizes, g, rows, lo, hi);
  if (hi <= lo) return;  // an empty group: no weight is read

  const int n_steps = (k + kDepth - 1) / kDepth;
  // The consumers take stages in pairs (two register buffers): an odd
  // count gets one more stage, loaded from past K, where every box reads
  // as zeros.
  const int steps = (n_steps + 1) & ~1;
  const int passes = (hi - lo + NR - 1) / NR;

  if (threadIdx.x == 0) {
    for (int i = 0; i < W::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4) {
    // Producer: one thread keeps the ring full, pass after pass.
    if (lane == 0) {
      const CUtensorMap* q_map = half ? &q1_map : &q0_map;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(q_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&x_map))
                   : "memory");
      for (int p = 0; p < passes; ++p) {
        const int r0 = lo + p * NR;
        for (int s = 0; s < steps; ++s) {
          const int it = p * steps + s;
          const int st = it % W::STAGES;
          mbar_wait(&empty[st], ((it / W::STAGES) & 1) ^ 1);
          unsigned char* b = smem + st * W::STAGE;
          const int k0 = s * kDepth;  // past K on the padding stage
          mbar_expect_tx(&full[st], W::STAGE);
          tma_load(b, q_map, &full[st], hc0, k0, g);
          tma_load(b + kQBox, &x_map, &full[st], k0, r0);
        }
      }
    }
    return;
  }

  // The consumer warpgroup owns the block's 128 columns as two m64
  // blocks: in block mb, thread (warp, g8) holds columns bx and bx + 1,
  // bx = 64 mb + 16 warp + 2 g8 (int8_image.cuh, swap_fragments).
  const int g8 = lane >> 2, t = lane & 3;
  int bx[2];
  float s0[2], s1[2];
  const float* sg = scale + g * sc_lay.se + half * sc_lay.sh;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    bx[mb] = 64 * mb + 16 * warp + 2 * g8;
    const int col = hc0 + bx[mb];
    // half_n % 16 == 0: col < half_n means col + 1 < half_n too.
    s0[mb] = col < half_n ? sg[col] : 0.f;
    s1[mb] = col < half_n ? sg[col + 1] : 0.f;
  }
  float acc[2][NR / 2];

  // One stage: its fragments into fr, its 8 products issued, then the
  // previous stage's products waited for and that stage released. No
  // conditional product, and the accumulators are touched only after the
  // last wait: either would make ptxas serialise the products.
  auto stage = [&](int it, uint32_t (&fr)[2][4][4]) {
    const int st = it % W::STAGES;
    mbar_wait(&full[st], (it / W::STAGES) & 1);
    const unsigned char* base = smem + st * W::STAGE;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
      swap_fragments<false>(base, bx[mb], t, nullptr, fr[mb]);
    fence_regs(fr[0]);
    fence_regs(fr[1]);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
    const uint32_t xa = smem_u32(base + kQBox);
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_kmajor<NR>(acc[mb], fr[mb][kk], kmajor_desc(xa + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % W::STAGES]);
  };

  for (int p = 0; p < passes; ++p) {
    const int r0 = lo + p * NR;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < NR / 2; ++i) acc[mb][i] = 0.f;
    // Two register buffers: a stage's fragments are written only after
    // the products that read the same buffer two stages before are done.
    uint32_t fa[2][4][4], fb[2][4][4];
    for (int s = 0; s < steps; s += 2) {
      stage(p * steps + s, fa);
      fence_regs(fb[0]);
      fence_regs(fb[1]);
      stage(p * steps + s + 1, fb);
      fence_regs(fa[0]);
      fence_regs(fa[1]);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);

    // acc[mb][4 j + q]: group row r0 + 8 j + 2 t + (q & 1), column bx +
    // (q >> 1).
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int col = hc0 + bx[mb];
      if (col >= half_n) continue;
#pragma unroll
      for (int j = 0; j < NR / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * j + 2 * t + h;
          if (row >= hi) continue;
          *reinterpret_cast<__nv_bfloat162*>(out_h + (size_t)row * n +
                                             col) =
              __floats2bfloat162_rn(acc[mb][4 * j + h] * s0[mb],
                                    acc[mb][4 * j + 2 + h] * s1[mb]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Wide: the warp-specialised wgmma body.
// ---------------------------------------------------------------------------

constexpr int kXBox = kRowTile * kRowBytes;  // lhs tile: 128 rows x 64 k
constexpr int kImages = 3;  // two stages' products in flight, one converting
constexpr int kStages = 4;  // loaded a step before its conversion, released
                            // two after its products: fewer would wait on
                            // itself

constexpr int kWideCols = 256;               // output columns of a block
constexpr int kWN = kWideCols / 2;           // a consumer's columns
constexpr int kWideStage = kXBox + kDepth * kWideCols;
constexpr int kImg = (kWN / 64) * kBox;      // one consumer's image
// Shared memory (byte offsets from a 1024-aligned base): kStages stages of
// the lhs tile then the int8 tile [64][256]; each consumer's kImages bf16
// images of its 128 columns (two boxes each); the full and empty barriers.
constexpr int kImg0 = kStages * kWideStage;  // consumer c, image i:
                                             // kImg0 + (kImages c + i) kImg
constexpr int kBars = kImg0 + 2 * kImages * kImg;
constexpr int kWideSmem = kBars + 2 * kStages * 8 + 1024;
static_assert(kMinSmem <= kWideSmem && kWideSmem <= 232448, "shared memory");

// One stage's products of a consumer: its 128 rows (two m64 halves) by its
// 128 columns, k16 by k16; A (lhs) K-major, B (the image) MN-major through
// the transpose bit.
__device__ __forceinline__ void wide_products(float (&acc)[2][kWN / 2],
                                              uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kDepth / 16; ++kk) {
    const uint64_t db = mnmajor_desc(b + kk * 16 * kRowBytes, kBox);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t da = kmajor_desc(a + h * 64 * kRowBytes + kk * 32);
      wgmma_ss_n128<0, 1>(acc[h], da, db, 1);
    }
  }
}

// x_map: lhs [rows, K] bf16 in 64 x 128 swizzled boxes; q_map[h]: half h
// [E, K, half_n] int8 in 256 x 64 x 1 plain boxes. Block blockIdx.x: (row
// item, column block) by the raster; per_half column blocks a half.
__global__ void __launch_bounds__(kWgThreads, 1)
grouped_matmul_int8_wide(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap q0_map,
                         const __grid_constant__ CUtensorMap q1_map,
                         const float* __restrict__ scale,
                         const int32_t* __restrict__ sizes,
                         bf16* __restrict__ out, int rows, int k, int n,
                         int n_groups, int per_half, int n_items,
                         Scales sc_lay) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* empty = full + kStages;

  int item, cb;
  swizzle(blockIdx.x, n_items, gridDim.x / n_items, item, cb);
  const int half = cb / per_half;
  const int hc0 = (cb % per_half) * kWideCols;
  const int half_n = sc_lay.half_n;
  bf16* out_h = out + half * half_n;

  // The block's work (K10a's walk): rows [lo, hi) of group `group` in row
  // tile `tile`, or, past the intersections, the zeros of the rows past
  // the last group in a tile from the one holding the first of them on.
  int group = -1, tile = 0, lo = 0, hi = 0, start = 0;
  for (int e = 0; e < n_groups; ++e) {
    const int size = max(sizes[e], 0);
    const int s = min(start, rows), f = min(start + size, rows);
    const int cnt = f > s ? (f - 1) / kRowTile - s / kRowTile + 1 : 0;
    if (item < cnt) {
      group = e;
      tile = s / kRowTile + item;
      lo = max(s, tile * kRowTile);
      hi = min(f, tile * kRowTile + kRowTile);
      break;
    }
    item -= cnt;
    start += size;
  }
  if (group < 0) {
    const int total = min(start, rows);
    tile = total / kRowTile + item;
    lo = max(total, tile * kRowTile);
    hi = min(rows, tile * kRowTile + kRowTile);
    zero_rows(out_h, n, lo, hi, hc0, kWideCols, half_n, kWgThreads);
    return;
  }
  const int m0 = tile * kRowTile;
  const int n_steps = (k + kDepth - 1) / kDepth;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) >> 5, lane = threadIdx.x & 31;
  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const CUtensorMap* q_map = half ? &q1_map : &q0_map;
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % kStages;
        mbar_wait(&empty[st], ((step / kStages) & 1) ^ 1);
        unsigned char* a = smem + st * kWideStage;
        const int k0 = step * kDepth;
        mbar_expect_tx(&full[st], kWideStage);
        tma_load(a, &x_map, &full[st], k0, m0);
        tma_load(a + kXBox, q_map, &full[st], hc0, k0, group);
      }
    }
    return;
  }

  // Consumer warpgroup c owns half columns hc0 + 128 c .. + 127 of all
  // 128 rows, and converts those columns of each int8 tile itself: thread
  // tid keeps one group of 8 columns and converts every RP-th row of it.
  setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  constexpr int G = kWN / 8, RP = 128 / G;
  const int grp = tid % G, rp = tid / G;
  // The group's 16 bytes of an image row: box grp / 8, chunk grp % 8,
  // permuted by the 128-byte swizzle (chunk ^ row % 8).
  const int img_col = (grp / 8) * kBox, chunk = grp % 8;
  unsigned char* images = smem + kImg0 + kImages * c * kImg;

  // Converts stage `step`'s int8 columns into image step % kImages, fences
  // the writes into the async proxy and meets the warpgroup's other warps.
  auto convert = [&](int step) {
    const unsigned char* q8 =
        smem + (step % kStages) * kWideStage + kXBox + kWN * c + grp * 8;
    unsigned char* img = images + (step % kImages) * kImg + img_col;
    convert_rows<false, RP>(q8, kWideCols, img, chunk, rp, nullptr);
    fence_proxy_async();
    named_sync(1 + c, 128);
  };

  float acc[2][kWN / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < kWN / 2; ++i) acc[h][i] = 0.f;

  mbar_wait(&full[0], 0);
  convert(0);
  // No conditional product and no touch of the accumulators while
  // products are in flight: either makes ptxas wait for them. Rows outside
  // the group, and columns past the half (zero-filled, converted to
  // zeros), cost products but are not stored.
  for (int step = 0; step < n_steps; ++step) {
    const int st = step % kStages;
    wgmma_fence();
    wide_products(acc, smem_u32(smem + st * kWideStage),
                  smem_u32(images + (step % kImages) * kImg));
    wgmma_commit();
    // Up to two stages' products in flight: the one before the previous is
    // done, so its lhs tile and its image are free, and the next stage
    // converts into that image while these two run.
    wgmma_wait<2>();
    if (step > 1 && lane == 0) mbar_arrive(&empty[(step - 2) % kStages]);
    if (step + 1 < n_steps) {
      mbar_wait(&full[(step + 1) % kStages], ((step + 1) / kStages) & 1);
      convert(step + 1);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  const int c0 = hc0 + kWN * c;
  if (c0 >= half_n) return;
  const int g8 = lane >> 2, t = lane & 3;
  const float* sg = scale + group * sc_lay.se + half * sc_lay.sh;
#pragma unroll
  for (int j = 0; j < kWN / 8; ++j) {
    const int col = c0 + j * 8 + 2 * t;
    if (col >= half_n) continue;  // half_n % 16 == 0: so is col + 1
    const float s0 = sg[col], s1 = sg[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + 64 * h + warp * 16 + g8 + 8 * hh;
        if (row < lo || row >= hi) continue;
        *reinterpret_cast<__nv_bfloat162*>(out_h + (size_t)row * n + col) =
            __floats2bfloat162_rn(acc[h][4 * j + 2 * hh] * s0,
                                  acc[h][4 * j + 2 * hh + 1] * s1);
      }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// One launch's arguments (the C entry point's, in one place).
struct Args {
  const void *lhs, *q, *scale, *sizes;
  void* out;
  int rows, k, n, n_groups, halves;
  long long q_se, q_sk, q_sh;
  Scales sc;
  cudaStream_t st;
};

// Half h's rank-3 map [E, K, half_n] over q at the half's base pointer:
// int8 boxes of box_cols x 64 x 1, 128-byte swizzled (the narrow body's
// 128 columns) or plain rows.
int half_map(CUtensorMap* map, const Args& g, int h, int box_cols,
             bool swizzled) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(g.sc.half_n),
                              static_cast<cuuint64_t>(g.k),
                              static_cast<cuuint64_t>(g.n_groups)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(g.q_sk),
                                 static_cast<cuuint64_t>(g.q_se)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), kDepth, 1};
  const void* base = static_cast<const int8_t*>(g.q) + h * g.q_sh;
  return tensor_map_of(map, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                       swizzled ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_NONE,
                       base, 3, dims, strides, box);
}

// The maps of a launch: lhs in 64 x x_rows boxes, each half's weights.
int maps(const Args& g, int x_rows, int box_cols, bool swizzled,
         CUtensorMap* xm, CUtensorMap* q0, CUtensorMap* q1) {
  if (int rc = matrix_map(xm, g.lhs, g.rows, g.k, x_rows)) return rc;
  if (int rc = half_map(q0, g, 0, box_cols, swizzled)) return rc;
  if (g.halves == 1) {
    *q1 = *q0;
    return 0;
  }
  return half_map(q1, g, 1, box_cols, swizzled);
}

template <int NR>
int launch_narrow(const Args& g, int per_half) {
  using W = Narrow<NR>;
  // Raised before the tensor maps are encoded: this runtime call binds the
  // device's context to the calling thread, which the driver's encoder
  // needs.
  if (int rc = static_cast<int>(cudaFuncSetAttribute(
          grouped_matmul_int8_narrow<NR>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM)))
    return rc;
  CUtensorMap xm, q0, q1;
  if (int rc = maps(g, NR, kNarrowCols, true, &xm, &q0, &q1)) return rc;
  const dim3 grid(g.halves * per_half, g.n_groups + 1);
  grouped_matmul_int8_narrow<NR><<<grid, kNarrowThreads, W::SMEM, g.st>>>(
      xm, q0, q1, static_cast<const float*>(g.scale),
      static_cast<const int32_t*>(g.sizes), static_cast<bf16*>(g.out),
      g.rows, g.k, g.n, g.n_groups, per_half, g.sc);
  return static_cast<int>(cudaGetLastError());
}

int launch_wide(const Args& g, int per_half, int n_items) {
  if (int rc = static_cast<int>(cudaFuncSetAttribute(
          grouped_matmul_int8_wide,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem)))
    return rc;
  CUtensorMap xm, q0, q1;
  if (int rc = maps(g, kRowTile, kWideCols, false, &xm, &q0, &q1)) return rc;
  const unsigned blocks =
      static_cast<unsigned>(n_items) * g.halves * per_half;
  grouped_matmul_int8_wide<<<blocks, kWgThreads, kWideSmem, g.st>>>(
      xm, q0, q1, static_cast<const float*>(g.scale),
      static_cast<const int32_t*>(g.sizes), static_cast<bf16*>(g.out),
      g.rows, g.k, g.n, g.n_groups, per_half, n_items, g.sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out bf16 [rows, n] = the grouped product of lhs bf16 [rows, k] with the
// int8 stack q (strides q_se, q_sk, q_sh in bytes: expert, row, half) and
// the f32 scales (strides s_se, s_sh in elements), n = half_n or 2 half_n.
// k and half_n in steps of 16; q, its strides and lhs's rows 16-byte
// aligned. The plan (ops/moe_dispatch.py::int8_gmm_plan): body 0, the
// narrow body with nr group rows a pass (16, 32 or 64) and cols 128
// output columns a block; body 1, the wide body, nr 128 and cols 256;
// grid_x x grid_y the grid it computed, checked here. Returns -1 for what
// it does not take.
extern "C" int grouped_matmul_int8(const void* lhs, const void* q,
                                   const void* scale, const void* group_sizes,
                                   void* out, int rows, int k, int n,
                                   int n_groups, int half_n, long long q_se,
                                   long long q_sk, long long q_sh,
                                   long long s_se, long long s_sh, int body,
                                   int nr, int cols, long long grid_x,
                                   long long grid_y, void* stream) {
  if (rows < 0 || k <= 0 || k % 16 || half_n <= 0 || half_n % 16 ||
      (n != half_n && n != 2 * half_n) || n_groups <= 0 || q_se % 16 ||
      q_sk % 16 || q_sh % 16)
    return -1;
  if (rows == 0) return 0;
  const Args g{lhs, q, scale, group_sizes, out, rows, k, n, n_groups,
               n / half_n, q_se, q_sk, q_sh, {s_se, s_sh, half_n},
               static_cast<cudaStream_t>(stream)};
  if (body == 0) {
    const int per_half = (half_n + kNarrowCols - 1) / kNarrowCols;
    if (cols != kNarrowCols || grid_x != (long long)g.halves * per_half ||
        grid_y != n_groups + 1 || grid_y > 65535)
      return -1;
    if (nr == 16) return launch_narrow<16>(g, per_half);
    if (nr == 32) return launch_narrow<32>(g, per_half);
    if (nr == 64) return launch_narrow<64>(g, per_half);
    return -1;
  }
  if (body != 1 || nr != kRowTile || cols != kWideCols) return -1;
  const int per_half = (half_n + kWideCols - 1) / kWideCols;
  const long long n_items = (rows + kRowTile - 1) / kRowTile + n_groups;
  if (grid_x != n_items * g.halves * per_half || grid_y != 1 ||
      grid_x > 0x7fffffffLL)
    return -1;
  return launch_wide(g, per_half, static_cast<int>(n_items));
}
