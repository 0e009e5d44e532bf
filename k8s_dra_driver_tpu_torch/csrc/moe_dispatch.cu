// Fused MoE dispatch for Hopper (sm_90a): the gather + gate/up + SwiGLU
// kernel and the down-projection + gated combine kernel of the dropless
// MoE MLP.
//
// Replaces:
//   moe_gateup       <- k8s_dra_driver_tpu/ops/moe_dispatch.py::_gateup_kernel
//                       (with _gather_rows_dma)
//   moe_down_combine <- k8s_dra_driver_tpu/ops/moe_dispatch.py::_down_combine_kernel
//                       (with _scatter_rows_dma)
//   moe_gateup_int8, moe_down_combine_int8 <- the `quantized` branches of
//                       the same two kernels (int8 experts, f32 scales)
//
// Layouts are the JAX package's; the dispatch plan (ops/moe_dispatch.py
// build_plan) puts every (token, expert) pair in an expert-major buffer of
// r_pad rows whose expert regions start at multiples of `tile`, so each row
// tile belongs to one expert, tile_expert[i]:
//   moe_gateup:       xf [T, H] bf16, w_gu [E, H, 2, M] bf16 (gate and up
//                     interleave on the axis of size 2, M contiguous: as
//                     [E, H, 2M], gate columns [0, M), up [M, 2M)),
//                     row_ids [r_pad] int32 (sentinel T: a zero row)
//                     -> act [r_pad, M] bf16 = silu(g) * u, g and u in f32
//   moe_down_combine: act [r_pad, M] bf16, w_down [E, M, H] bf16,
//                     gates [r_pad] f32, pair_ids [r_pad] int32 (sentinel
//                     n_pairs: not written) -> out [n_pairs, H] f32, which
//                     the caller zero-fills; each live row writes
//                     (act_row . W_down[e]) * gate to its own pair slot, so
//                     no two rows share a slot and no atomics are needed.
// The int8 branches take the stacks as int8 with per-column f32 scales
// (w_gu's [E, 1, 2, M], w_down's [E, 1, H]); the scales are constant over
// the contracted axis, so they multiply the f32 sums: g and u before SwiGLU,
// the down product before the gate. A tile whose rows are all sentinels
// reads no weights: moe_gateup writes its zeros, moe_down_combine returns.
//
// What bounds them on the H100. At decode (8 tokens, 16 pairs, tile 8)
// every touched expert's weights are read once for a handful of rows: bound
// by bytes (1.88 GB for the gate/up stack and 0.94 GB for the down stack of
// one Mixtral-8x7B layer in bf16, half that in int8: 0.28-0.56 ms at 3.35
// TB/s). At a 512-token prefill chunk (tile 128, ~128 rows an expert) each
// weight byte feeds ~128 rows, near the line between bytes and operations;
// in training (T 8192, ~2048 rows an expert) bound by operations (3.9 and
// 1.9 ms at 989 TFLOP/s).
//
// Design: one body for every tile, the warp-specialised wgmma body of the
// grouped GEMMs (grouped_gemm.cuh; grouped_matmul.cu's gmm), one block of 3
// warpgroups per (row tile, column block), the row tiles raster 8 to a
// column sweep so the tiles' rows and their experts' weights stay in the 50
// MB L2. ops/moe_dispatch.py::dispatch_plan picks the form, the column
// block and the int8 K8's split from host integers (tile, r_pad, widths,
// SMs).
//   - The tile's rows are a box of 128 rows (kFull; a tile under 128 rows
//     also reads the next tile's rows, whose products are never stored:
//     each output row depends only on its own A row), of 64 (kHalf: tiles
//     of at most 64 rows) or of 16 (kSwap). A ring of 64-deep stages of
//     them and of the weights, guarded by full and empty mbarriers.
//   - The weights land by TMA through a rank-3 map over the stack, as
//     stored. moe_down_combine: w_down [E, M, H], OUT = SB = 256, 128 or 64
//     columns a block (the widest that divides H). moe_gateup: w_gu as [E,
//     H, 2M]; a stage holds OUT = 128 (or 64) gate columns at c0 and the
//     same up columns at M + c0, SB = 2 OUT side by side, so each thread's
//     accumulators hold g and u of the same elements and SwiGLU runs in
//     registers.
//   - The rows: moe_down_combine loads act's rows by TMA (rank-2 map over
//     [r_pad, M]; rows past r_pad read as zeros). moe_gateup gathers: TMA
//     cannot gather by index on Hopper, so the producer warpgroup's warps
//     1-3 copy 16-byte chunks of xf[row_ids[r]] by cp.async into the
//     128-byte swizzled address (chunk ^ (row & 7)), sentinel rows
//     zero-filled (a source size of 0). Each gathering thread keeps
//     kGatherLag stages of copies in flight, waits for the oldest, fences
//     its writes into the async proxy, and its warp arrives on that stage's
//     full barrier beside the TMA's arrival. The sorted [r_pad, H] buffer
//     never exists.
//   - bf16 products: wgmma m64n{NW}k16 on operands as stored (rows
//     K-major, weights MN-major through the transpose bit). Consumer c owns
//     rows 64 c.. and all SB columns (kHalf: rows 0-63 and half the
//     columns), one stage's products in flight while it waits for the next
//     (gmm's loop).
//   - int8 products, kFull and kHalf: each consumer converts the columns
//     its products read into its own swizzled MN-major bf16 image
//     (int8_image.cuh, int8_matmul's wide body) while its previous stage's
//     products run, no barrier between the consumers. At SB 256 consumer c owns half the columns and all the
//     rows (two m64 halves; kHalf one); at SB <= 128 it owns 64 rows and
//     converts all SB columns (both consumers convert them: narrow widths
//     only).
//   - int8 at decode (kSwap: tiles of at most 16 rows, SB 256): bound by
//     the weight stream, where an image's store, fence, barrier and reads
//     cost more shared-memory traffic than the products. The operands swap:
//     the weights' columns are wgmma's M, as register A fragments each
//     thread converts straight from the int8 tile (TMA lands it in
//     swizzled 128-column boxes, so the fragment's rows load from distinct
//     banks), and the tile's 16 rows are N (m64n16k16, the rows K-major).
//     Two register buffers: a stage converts while the one before
//     multiplies.
//   - Every product is issued unconditionally and the accumulators are
//     touched only after the last wait, so ptxas does not serialise wgmma.
//   - moe_down_combine_int8 splits its contracted axis (M) 2 or 4 ways where
//     its blocks, so split, still fit one wave (narrow widths: 8x160m's H
//     768): each split writes its gated f32 partial rows to a zero-filled
//     scratch [split, n_pairs, H], and a second pass sums the splits in
//     order, so two calls give the same bits.
//
// Left out, measured slower on the H100 (PERF.md): the mma.sync body of the
// first port at decode (a 6-deep cp.async ring, mma.sync.m16n8k16 and, for
// int8, a block-wide conversion per 32-deep stage), K8's split where its
// blocks fill the SMs, and any split of bf16 K8.

#include "grouped_gemm.cuh"  // ring geometry, raster, stage products, maps
#include "int8_image.cuh"    // int8 tiles into swizzled bf16 images

namespace {

typedef __nv_bfloat16 bf16;

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = smem_u32(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// The int8 K8's split pass: out[i] = the sum over s of part[s, i], in
// order.
__global__ void __launch_bounds__(256)
moe_split_reduce(const float* __restrict__ part, float* __restrict__ out,
                 size_t total, int split) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  float4 v = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < split; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(part + s * total + i);
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  *reinterpret_cast<float4*>(out + i) = v;
}

// Launches the split pass after a split kernel (checking that kernel's
// launch first).
int reduce_splits(void* part, void* out, int n_pairs, int ndim, int split,
                  cudaStream_t st) {
  if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  const size_t total = (size_t)n_pairs * ndim;
  if (total > 0)
    moe_split_reduce<<<static_cast<unsigned>((total / 4 + 255) / 256), 256, 0, st>>>(
            static_cast<const float*>(part), static_cast<float*>(out), total,
            split);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The body.
// ---------------------------------------------------------------------------

constexpr int kGatherWarps = 3;  // producer warps 1-3 gather K7's rows
constexpr int kGatherLag = 2;    // stages of gathering copies in flight

// The forms of the body: kFull, a 128-row box; kHalf (SB 256 only), a
// tile of at most 64 rows, whose box's upper m64 half is neither loaded nor
// multiplied; kSwap (int8, SB 256, tiles of at most 16 rows): the operands
// swapped, the weights' columns as wgmma's M (register A fragments
// converted straight from the int8 tile) and the tile's 16 rows as N.
constexpr int kFull = 0, kHalf = 1, kSwap = 2;

// GATEUP: moe_gateup, else moe_down_combine; INT8: int8 weights; SB: staged
// weight columns of a stage (moe_gateup: gate then up, OUT each); FORM: as
// above.
template <bool GATEUP, bool INT8, int SB, int FORM>
struct Cfg {
  // Consumers split the columns (else the rows): int8 at SB 256, so that
  // each converts only the columns it multiplies, and kHalf, kSwap.
  static constexpr bool COLS = SB == 256 && (INT8 || FORM != kFull);
  static constexpr int MH = COLS && FORM == kFull ? 2 : 1;  // m64 halves
  static constexpr int NW = COLS ? SB / 2 : SB;  // a consumer's columns
  // bf16 COLS: consumer c's B boxes start B_OFF c bytes into the stage,
  // B_LBO apart (moe_gateup: gate box c and up box 2 + c).
  static constexpr int B_OFF = !INT8 && COLS ? (GATEUP ? kBox : 2 * kBox) : 0;
  static constexpr int B_LBO = !INT8 && COLS && GATEUP ? 2 * kBox : kBox;
  static constexpr int OUT = GATEUP ? SB / 2 : SB; // output columns a block
  // The A box: 128 rows x 64 (16 KB), kHalf its m64 half, kSwap 16 rows.
  static constexpr int A =
      (FORM == kSwap ? 16 : FORM == kHalf ? 64 : kRowTile) * kRowBytes;
  static constexpr int B = INT8 ? SB * kDepth : SB * kRowBytes;
  static constexpr int STAGE = A + B;
  static constexpr int IMG = INT8 ? NW * kRowBytes : 0;  // NW / 64 boxes
  // int8 images a consumer: one converting while the products of the
  // other run; kSwap converts into registers.
  static constexpr int IMAGES = INT8 && FORM != kSwap ? 2 : 0;
  static constexpr int RING =
      INT8 ? 232448 - 2048 - 2 * IMAGES * IMG : 192 * 1024;
  static constexpr int STAGES = RING / STAGE < 8 ? RING / STAGE : 8;
  // Byte offsets from the 1024-aligned base: the stages, each consumer's
  // images, the full and empty barriers, then a_row[128] and dst_row[128].
  static constexpr int IMG0 = STAGES * STAGE;
  static constexpr int BARS = IMG0 + 2 * IMAGES * IMG;
  static constexpr int ROWS = BARS + 2 * STAGES * 8;
  static constexpr int USED = ROWS + 2 * kRowTile * 4;
  static constexpr int BYTES = USED + 1024 > kMinSmem ? USED + 1024
                                                      : kMinSmem;
  // Releasing stage j waits for stage j + 1 to land, and a gathering warp
  // arrives kGatherLag stages late: a ring of fewer than kGatherLag + 2
  // stages would wait on itself.
  static_assert(STAGES >= kGatherLag + 2 && BYTES <= 232448, "ring");
  static_assert(NW % 64 == 0 && (!GATEUP || SB >= 128), "widths");
  static_assert(FORM == kFull || SB == 256, "kHalf, kSwap split 256 columns");
  static_assert(FORM != kSwap || INT8, "kSwap converts int8 weights");
};

// a_map: act [r_pad, M] in boxes of 64 x a_rows (moe_down_combine only:
// kSwap's 16 rows, else 64 where the tile has at most 64 and 128 above;
// rows of the box past the tile are never stored). b_map: the stack as [E,
// K, N] (moe_gateup: [E, H, 2M]), bf16 in 64 x 64 x 1 swizzled boxes, or
// int8 in boxes of OUT (moe_gateup; kSwap 128, swizzled) or SB columns x 64
// rows. Block (blockIdx.x, blockIdx.y): row tile and column block by the
// raster, and the split of the contracted axis (moe_down_combine_int8;
// gated partial rows to part [split, n_pairs, H] when there are several).
template <bool GATEUP, bool INT8, int SB, int FORM>
__global__ void __launch_bounds__(kWgThreads, 1)
moe_dispatch_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map,
                    const bf16* __restrict__ xf,       // moe_gateup's tokens
                    const float* __restrict__ wscale,  // INT8 scales
                    const int32_t* __restrict__ ids,   // row_ids, or pair_ids
                    const int32_t* __restrict__ tile_expert,
                    const float* __restrict__ gates,   // moe_down_combine
                    void* __restrict__ out,            // act, or y_pairs
                    float* __restrict__ part,          // split partials
                    int kdim, int ndim, int tile, int limit, int n_tiles,
                    int a_rows) {
  using W = Cfg<GATEUP, INT8, SB, FORM>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W::BARS);
  uint64_t* empty = full + W::STAGES;
  int* a_row = reinterpret_cast<int*>(smem + W::ROWS);
  int* dst_row = a_row + kRowTile;

  int ti, cj;
  swizzle(blockIdx.x, n_tiles, ndim / W::OUT, ti, cj);
  const int r0 = ti * tile;     // the tile's first slot
  const int c0 = cj * W::OUT;   // the block's first output column

  // Per row of the tile: where its A row comes from (moe_gateup; -1: a
  // zero row) and where its output goes (-1: nothing).
  int live = 0;
  if (threadIdx.x < kRowTile) {
    const int r = threadIdx.x;
    int src = -1, dst = -1;
    if (r < tile) {
      const int id = ids[r0 + r];
      const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(limit);
      live = ok;
      if (GATEUP) {
        src = ok ? id : -1;
        dst = r0 + r;
      } else {
        dst = ok ? id : -1;
      }
    }
    a_row[r] = src;
    dst_row[r] = dst;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&full[s], GATEUP ? 1 + kGatherWarps : 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!__syncthreads_or(live)) {
    // All sentinels: the output is zero, and no weight is read.
    if (GATEUP) {
      bf16* act = static_cast<bf16*>(out);
      for (int i = threadIdx.x; i < tile * (W::OUT / 8); i += kWgThreads) {
        const int r = i / (W::OUT / 8), c = (i % (W::OUT / 8)) * 8;
        *reinterpret_cast<uint4*>(act + (size_t)(r0 + r) * ndim + c0 + c) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  const int e = tile_expert[ti];
  const int k_len = kdim / gridDim.y, k_base = blockIdx.y * k_len;
  const int n_steps = k_len / kDepth;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) >> 5, lane = threadIdx.x & 31;

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (warp == 0) {
      // One thread starts every TMA load of the ring.
      if (lane == 0) {
        for (int step = 0; step < n_steps; ++step) {
          const int st = step % W::STAGES;
          mbar_wait(&empty[st], ((step / W::STAGES) & 1) ^ 1);
          unsigned char* a = smem + st * W::STAGE;
          unsigned char* b = a + W::A;
          const int k0 = k_base + step * kDepth;
#ifdef MOE_DISPATCH_NO_LOADS
          mbar_arrive(&full[st]);
          continue;
#endif
          mbar_expect_tx(&full[st],
                         GATEUP ? W::B : W::B + a_rows * kRowBytes);
          if (!GATEUP) tma_load(a, &a_map, &full[st], k0, r0);
          if constexpr (INT8) {
            // moe_gateup: the gate columns, then the up ones; kSwap's
            // moe_down_combine: two swizzled boxes of 128 columns.
            tma_load(b, &b_map, &full[st], c0, k0, e);
            if (GATEUP || FORM == kSwap)
              tma_load(b + W::B / 2, &b_map, &full[st],
                       GATEUP ? ndim + c0 : c0 + SB / 2, k0, e);
          } else {
#pragma unroll
            for (int j = 0; j < SB / 64; ++j) {
              // moe_gateup: boxes 0.. the gate columns, then the up ones.
              const int col = !GATEUP          ? c0 + 64 * j
                              : j < SB / 128   ? c0 + 64 * j
                                               : ndim + c0 + 64 * j - SB / 2;
              tma_load(b + j * kBox, &b_map, &full[st], col, k0, e);
            }
          }
        }
      }
    } else if (GATEUP) {
      // Warps 1-3 gather the tile's rows, kGatherLag stages of copies in
      // flight.
      const int gt = threadIdx.x - 32;
      for (int step = 0; step < n_steps + kGatherLag; ++step) {
        if (step < n_steps) {
          const int st = step % W::STAGES;
          mbar_wait(&empty[st], ((step / W::STAGES) & 1) ^ 1);
          unsigned char* a = smem + st * W::STAGE;
          const int k0 = k_base + step * kDepth;
#ifndef MOE_DISPATCH_NO_LOADS
          for (int i = gt; i < tile * 8; i += 32 * kGatherWarps) {
            const int r = i >> 3, ch = i & 7;
            const int src = a_row[r];
            cp_async16(a + r * kRowBytes + ((ch ^ (r & 7)) << 4),
                       xf + (size_t)(src < 0 ? 0 : src) * kdim + k0 + ch * 8,
                       src >= 0);
          }
#endif
        }
        cp_async_commit();
        if (step >= kGatherLag) {
          // Stage step - kGatherLag has landed: hand it to the async proxy.
          cp_async_wait<kGatherLag>();
          fence_proxy_async();
          __syncwarp();
          if (lane == 0)
            mbar_arrive(&full[(step - kGatherLag) % W::STAGES]);
        }
      }
    }
    return;
  }

  // Consumers.
  setmaxnreg_inc<232>();
  const int c = wg - 1;
  if constexpr (FORM == kSwap) {
    // Consumer c owns NW = 128 weight columns as two m64 blocks: moe_gateup
    // block 0 its 64 gate columns and block 1 the same up columns,
    // moe_down_combine columns c NW + 64 mb.. In block mb, thread (warp,
    // g8) holds rows g8 and g8 + 8 as columns x and x + 1, x = 16 warp + 2
    // g8 of the block, so K7's g and u of a column meet in one thread. Each
    // k16 step's A fragment comes straight from the swizzled int8 box
    // (int8_image.cuh, swap_fragments); B is the tile's 16 rows, K-major.
    const int g8 = lane >> 2, t = lane & 3;
    int box_off[2], bx[2];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int cc = GATEUP ? c * 64 + 16 * warp + 2 * g8
                            : c * W::NW + mb * 64 + 16 * warp + 2 * g8;
      box_off[mb] = (GATEUP ? mb : cc >> 7) * (W::B / 2);
      bx[mb] = cc & 127;
    }
    float acc[2][8];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[mb][i] = 0.f;
    auto stage = [&](int step, uint32_t (&fr)[2][4][4]) {
      const int st = step % W::STAGES;
      mbar_wait(&full[st], (step / W::STAGES) & 1);
      const unsigned char* base = smem + st * W::STAGE;
#ifndef MOE_DISPATCH_NO_CONVERT
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
        swap_fragments<false>(base + W::A + box_off[mb], bx[mb], t, nullptr,
                              fr[mb]);
#endif
      fence_regs(fr[0]);
      fence_regs(fr[1]);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
#ifndef MOE_DISPATCH_NO_PRODUCTS
      const uint32_t a = smem_u32(base);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n16(acc[mb], fr[mb][kk], kmajor_desc(a + kk * 32));
#endif
      wgmma_commit();
      // The previous stage's products are done: release its stage.
      wgmma_wait<1>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (step > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % W::STAGES]);
    };
    // Two register buffers: a stage's fragments are written only after the
    // products that read the same buffer two stages before are done.
    uint32_t fa[2][4][4], fb[2][4][4];
    for (int step = 0; step < n_steps; step += 2) {
      stage(step, fa);
      fence_regs(fb[0]);
      fence_regs(fb[1]);
      stage(step + 1, fb);
      fence_regs(fa[0]);
      fence_regs(fa[1]);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);

    // acc[mb][4 j + q]: token row 8 j + 2 t + (q & 1), column x + (q >> 1).
    const float* sc = wscale + (size_t)e * (GATEUP ? 2 * ndim : ndim);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * (i >> 2) + 2 * t + (i & 1);
      if (r >= tile) continue;
      const int x = 16 * warp + 2 * g8 + ((i & 3) >> 1);
      if constexpr (GATEUP) {
        const int col = c0 + c * 64 + x;
        static_cast<bf16*>(out)[(size_t)(r0 + r) * ndim + col] =
            __float2bfloat16_rn(silu_mul(acc[0][i] * sc[col],
                                         acc[1][i] * sc[ndim + col]));
      } else {
        const int dst = dst_row[r];
        if (dst < 0) continue;
        const float gt = gates[r0 + r];
        float* y = gridDim.y > 1
                       ? part + ((size_t)blockIdx.y * limit + dst) * ndim
                       : static_cast<float*>(out) + (size_t)dst * ndim;
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          const int col = c0 + c * W::NW + mb * 64 + x;
          y[col] = acc[mb][i] * sc[col] * gt;
        }
      }
    }
  } else {
    const int half0 = W::COLS ? 0 : c;  // the consumer's first m64 half

    float acc[W::MH][W::NW / 2];
#pragma unroll
    for (int h = 0; h < W::MH; ++h)
#pragma unroll
      for (int i = 0; i < W::NW / 2; ++i) acc[h][i] = 0.f;

    if constexpr (!INT8) {
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % W::STAGES;
        mbar_wait(&full[st], (step / W::STAGES) & 1);
        const uint32_t a = smem_u32(smem + st * W::STAGE);
#pragma unroll
        for (int h = 0; h < W::MH; ++h) fence_regs(acc[h]);
        wgmma_fence();
#ifndef MOE_DISPATCH_NO_PRODUCTS
#pragma unroll
        for (int h = 0; h < W::MH; ++h)
          stage_products<W::NW, 0, 1>(acc[h], a + (half0 + h) * kBox,
                                      a + W::A + c * W::B_OFF, W::B_LBO);
#endif
        wgmma_commit();
        // The previous stage's products are done: release it.
        wgmma_wait<1>();
#pragma unroll
        for (int h = 0; h < W::MH; ++h) fence_regs(acc[h]);
        if (step > 0 && lane == 0)
          mbar_arrive(&empty[(step - 1) % W::STAGES]);
      }
    } else {
      // Thread tid converts one group of 8 of the consumer's NW image columns
      // in every RP-th row. Image column i comes from: moe_down_combine, stage
      // column (COLS ? c NW : 0) + i (rows SB bytes apart); moe_gateup, i <
      // NW / 2 from the gate box, else the up box, column (COLS ? c NW / 2 :
      // 0) + i mod NW / 2 (rows SB / 2 bytes apart).
      constexpr int G8 = W::NW / 8, RP = 128 / G8;
      const int tid = threadIdx.x % 128;
      const int grp = tid % G8, rp = tid / G8;
      int src, stride;
      if (GATEUP) {
        const int part = grp * 8 >= W::NW / 2;
        src = part * (SB / 2) * kDepth + (W::COLS ? c * (W::NW / 2) : 0) +
              grp * 8 - part * (W::NW / 2);
        stride = SB / 2;
      } else {
        src = (W::COLS ? c * W::NW : 0) + grp * 8;
        stride = SB;
      }
      unsigned char* images = smem + W::IMG0 + W::IMAGES * c * W::IMG;
      auto convert = [&](int step) {
#ifndef MOE_DISPATCH_NO_CONVERT
        convert_rows<false, RP>(
            smem + (step % W::STAGES) * W::STAGE + W::A + src, stride,
            images + (step % W::IMAGES) * W::IMG + (grp / 8) * kBox, grp % 8,
            rp, nullptr);
#endif
        fence_proxy_async();
        named_sync(1 + c, 128);
      };

      if (n_steps > 0) {
        mbar_wait(&full[0], 0);
        convert(0);
      }
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % W::STAGES;
        const uint32_t a = smem_u32(smem + st * W::STAGE);
        const uint32_t b = smem_u32(images + (step % W::IMAGES) * W::IMG);
        wgmma_fence();
#ifndef MOE_DISPATCH_NO_PRODUCTS
#pragma unroll
        for (int h = 0; h < W::MH; ++h)
          stage_products<W::NW, 0, 1>(acc[h], a + (half0 + h) * kBox, b);
#endif
        wgmma_commit();
        // The previous stage's products are done, so its stage and its
        // image are free, and the next stage converts into that image while
        // these run.
        wgmma_wait<1>();
        if (step > 0 && lane == 0)
          mbar_arrive(&empty[(step - 1) % W::STAGES]);
        if (step + 1 < n_steps) {
          mbar_wait(&full[(step + 1) % W::STAGES],
                    ((step + 1) / W::STAGES) & 1);
          convert(step + 1);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < W::MH; ++h) fence_regs(acc[h]);

    // Epilogue: accumulator n8 block j holds columns 8 j + 2 t, + 1 of rows
    // g8 and g8 + 8 of the warp's 16.
    const int g8 = lane >> 2, t = lane & 3;
    const float* sc =
        INT8 ? wscale + (size_t)e * (GATEUP ? 2 * ndim : ndim) : nullptr;
#pragma unroll
    for (int h = 0; h < W::MH; ++h)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 64 * (half0 + h) + warp * 16 + g8 + 8 * hh;
        if (r >= tile) continue;  // the next tile's row: not this block's
        const int dst = dst_row[r];
        if constexpr (GATEUP) {
          bf16* act = static_cast<bf16*>(out) + (size_t)dst * ndim;
#pragma unroll
          for (int j = 0; j < W::NW / 16; ++j) {
            const int col =
                c0 + (W::COLS ? c * (W::NW / 2) : 0) + 8 * j + 2 * t;
            float g0 = acc[h][4 * j + 2 * hh];
            float g1 = acc[h][4 * j + 2 * hh + 1];
            float u0 = acc[h][4 * (j + W::NW / 16) + 2 * hh];
            float u1 = acc[h][4 * (j + W::NW / 16) + 2 * hh + 1];
            if constexpr (INT8) {
              g0 *= sc[col];
              g1 *= sc[col + 1];
              u0 *= sc[ndim + col];
              u1 *= sc[ndim + col + 1];
            }
            *reinterpret_cast<__nv_bfloat162*>(act + col) =
                __floats2bfloat162_rn(silu_mul(g0, u0), silu_mul(g1, u1));
          }
        } else {
          if (dst < 0) continue;
          const float gt = gates[r0 + r];
          float* y = gridDim.y > 1
                         ? part + ((size_t)blockIdx.y * limit + dst) * ndim
                         : static_cast<float*>(out) + (size_t)dst * ndim;
#pragma unroll
          for (int j = 0; j < W::NW / 8; ++j) {
            const int col = c0 + (W::COLS ? c * W::NW : 0) + 8 * j + 2 * t;
            float v0 = acc[h][4 * j + 2 * hh];
            float v1 = acc[h][4 * j + 2 * hh + 1];
            if constexpr (INT8) {
              v0 *= sc[col];
              v1 *= sc[col + 1];
            }
            *reinterpret_cast<float2*>(y + col) =
                make_float2(v0 * gt, v1 * gt);
          }
        }
      }
  }
}

// One launch's arguments (the C entry points', in one place).
struct Args {
  const void *a_src, *w, *wscale, *ids, *tile_expert, *gates;
  void *out, *part;
  int kdim, ndim, r_pad, tile, limit, n_experts, split;
  cudaStream_t st;
};

template <bool GATEUP, bool INT8, int SB, int FORM>
int launch(const Args& g) {
  using W = Cfg<GATEUP, INT8, SB, FORM>;
  auto kernel = moe_dispatch_kernel<GATEUP, INT8, SB, FORM>;
  const long long n_tiles = g.r_pad / g.tile;
  const long long blocks = n_tiles * (g.ndim / W::OUT);
  if (blocks > 0x7fffffffLL) return -1;
  // Raised before the tensor maps are encoded: this runtime call binds the
  // device's context to the calling thread, which the driver's encoder
  // needs.
  if (int rc = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::BYTES)))
    return rc;
  CUtensorMap am = {}, bm;
  // Rows of the A box (moe_down_combine's TMA): kSwap's 16, or the tile's
  // m64 half.
  const int a_rows = FORM == kSwap ? 16 : g.tile <= 64 ? 64 : kRowTile;
  if (!GATEUP) {
    if (int rc = matrix_map(&am, g.a_src, g.r_pad, g.kdim, a_rows)) return rc;
  }
  const int wcols = GATEUP ? 2 * g.ndim : g.ndim;
  if (int rc = INT8 ? int8_experts_map(&bm, g.w, g.n_experts, g.kdim, wcols,
                                       GATEUP || FORM == kSwap ? SB / 2 : SB,
                                       FORM == kSwap)
                    : experts_map(&bm, g.w, g.n_experts, g.kdim, wcols,
                                  kDepth))
    return rc;
  const dim3 grid(static_cast<unsigned>(blocks), g.split);
  kernel<<<grid, kWgThreads, W::BYTES, g.st>>>(
      am, bm, static_cast<const bf16*>(g.a_src),
      static_cast<const float*>(g.wscale),
      static_cast<const int32_t*>(g.ids),
      static_cast<const int32_t*>(g.tile_expert),
      static_cast<const float*>(g.gates), g.out, static_cast<float*>(g.part),
      g.kdim, g.ndim, g.tile, g.limit, static_cast<int>(n_tiles), a_rows);
  if (g.split > 1)
    return reduce_splits(g.part, g.out, g.limit, g.ndim, g.split, g.st);
  return static_cast<int>(cudaGetLastError());
}

// body 0: the wgmma body with `cols` output columns a block (moe_gateup
// 128 or 64, moe_down_combine 256, 128 or 64); body 1: its swapped form
// (int8, tiles up to 16, moe_gateup 128 / moe_down_combine 256 columns, an
// even number of 64-deep stages a split). moe_down_combine_int8's
// contracted axis splits `split` ways (1, 2 or 4) into `part`; the other
// entry points pass 1.
template <bool GATEUP, bool INT8>
int dispatch(const Args& g, int body, int cols) {
  if (g.tile <= 0 || g.tile % 8 || g.tile > kRowTile || g.r_pad <= 0 ||
      g.r_pad % g.tile || g.kdim <= 0 || g.ndim <= 0 || g.limit < 0 ||
      g.n_experts <= 0 || cols <= 0 || g.ndim % cols ||
      (g.split != 1 && g.split != 2 && g.split != 4) ||
      (g.split > 1 && g.part == nullptr) ||
      (body != 0 && body != 1) || g.kdim % (kDepth * g.split))
    return -1;
  const int sb = GATEUP ? 2 * cols : cols;
  if (body == 1) {
    if constexpr (INT8) {
      if (sb == 256 && g.tile <= 16 && (g.kdim / g.split) % (2 * kDepth) == 0)
        return launch<GATEUP, true, 256, kSwap>(g);
    }
    return -1;
  }
  if (sb == 256)
    return g.tile <= 64 ? launch<GATEUP, INT8, 256, kHalf>(g)
                        : launch<GATEUP, INT8, 256, kFull>(g);
  if (sb == 128) return launch<GATEUP, INT8, 128, kFull>(g);
  if constexpr (!GATEUP) {
    if (sb == 64) return launch<false, INT8, 64, kFull>(g);
  }
  return -1;
}

}  // namespace

// The plan's arguments (body, cols and moe_down_combine_int8's split) come
// from
// ops/moe_dispatch.py::dispatch_plan; -1 refuses a shape or plan.
extern "C" int moe_gateup(const void* xf, const void* w_gu,
                          const void* row_ids, const void* tile_expert,
                          void* act, int n_tokens, int h, int m, int r_pad,
                          int tile, int n_experts, int body, int cols,
                          void* stream) {
  return dispatch<true, false>(
      {xf, w_gu, nullptr, row_ids, tile_expert, nullptr, act, nullptr, h, m,
       r_pad, tile, n_tokens, n_experts, 1, static_cast<cudaStream_t>(stream)},
      body, cols);
}

extern "C" int moe_down_combine(const void* act, const void* w_down,
                                const void* gates, const void* pair_ids,
                                const void* tile_expert, void* out,
                                int n_pairs, int m, int h, int r_pad,
                                int tile, int n_experts, int body, int cols,
                                void* stream) {
  return dispatch<false, false>(
      {act, w_down, nullptr, pair_ids, tile_expert, gates, out, nullptr, m,
       h, r_pad, tile, n_pairs, n_experts, 1,
       static_cast<cudaStream_t>(stream)},
      body, cols);
}

extern "C" int moe_gateup_int8(const void* xf, const void* w_gu,
                               const void* scale, const void* row_ids,
                               const void* tile_expert, void* act,
                               int n_tokens, int h, int m, int r_pad,
                               int tile, int n_experts, int body, int cols,
                               void* stream) {
  return dispatch<true, true>(
      {xf, w_gu, scale, row_ids, tile_expert, nullptr, act, nullptr, h, m,
       r_pad, tile, n_tokens, n_experts, 1, static_cast<cudaStream_t>(stream)},
      body, cols);
}

extern "C" int moe_down_combine_int8(const void* act, const void* w_down,
                                     const void* scale, const void* gates,
                                     const void* pair_ids,
                                     const void* tile_expert, void* out,
                                     void* part, int n_pairs, int m, int h,
                                     int r_pad, int tile, int n_experts,
                                     int body, int cols, int split,
                                     void* stream) {
  return dispatch<false, true>(
      {act, w_down, scale, pair_ids, tile_expert, gates, out, part, m, h,
       r_pad, tile, n_pairs, n_experts, split,
       static_cast<cudaStream_t>(stream)},
      body, cols);
}
