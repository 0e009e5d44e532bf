// int8-weight matrix product for Hopper (sm_90a): the dense seams of the
// int8 serving path and the int8 expert products of the einsum MoE body.
//
// Replaces (the reference leaves both to XLA, no Pallas kernel):
//   int8_matmul, SCALE_EPILOGUE <- k8s_dra_driver_tpu/models/quant.py::
//       _mixed_dot then `* scale` (q_einsum, q_matmul): the weight stays
//       int8 into the dot, the sum is f32, the per-column scale multiplies
//       the f32 sum, one cast at the end;
//   int8_matmul, SCALE_PROLOGUE <- ::q_dequant then the bf16 expert einsums
//       of k8s_dra_driver_tpu/models/moe.py: the weight is dequantized to
//       bf16(q * scale) -- the reference's rounding -- but only tile by tile
//       in shared memory, never as a whole stack in device memory.
//
// Computes, for each batch entry e (the expert axis of the MoE body, 1 for
// the seams):
//   y[e, m, n] = bf16( sum_k x[e, m, k] * q[e, k, n] * scale[e, n] )
// with x bf16 [E, M, K], q int8 [E, K, N], scale f32 [E, N], y bf16 [E, M,
// N], the sum in f32 from bf16 operands: q as bf16 (exact) and the scale in
// the epilogue, or bf16(q * scale) (the prologue mode). Any M; K a multiple
// of 64 (of 64 x split); N a multiple of 16, the ragged last column tile
// masked. No atomics: two calls give the same bits.
//
// What bounds it on the H100. At decode (M 8) each weight byte feeds 8
// rows: 16 operations a byte, bound by bytes -- the int8 weight streams
// once (Mixtral-8x7B's wqkv + wo per layer and the LM head: 1.47 GB a
// decode step, 0.44 ms at 3.35 TB/s). At a packed prefill (M 512) and in
// the MoE body's expert products (M = capacity, 320-512) it is bound by
// operations, so the products must be wgmma there.
//
// Two bodies, chosen by M; the wrapper (ops/quant_matmul.py::plan) picks
// the K split from host integers.
//
// M <= 64 (decode, drafts, verify windows): the swapped form of the int8
// MoE kernels' decode body (moe_dispatch.cu, kSwap). There the weight
// stream binds, and a first version here (a cp.async ring, each stage
// converted into a bf16 image in shared memory, ldmatrix.trans +
// mma.sync.m16n8k16 after a barrier, M padded to 16 rows, 64 columns a
// block) spent more shared-memory traffic on the image's store, fence,
// barrier and reads than on the products. So the operands swap: the
// weight's columns are wgmma's M, as register A fragments each thread
// converts straight from the int8 tile (int8_image.cuh, swap_fragments;
// two register buffers, a stage converting while the one before
// multiplies), and x's rows are N, rounded up to 8, 16, 32 or 64 (M 1, 5
// and 8 pay for 8 rows, not 16), its tile K-major.
//   - A block of 160 threads owns 128 columns (two m64 blocks): warps 0-3,
//     the consumer warpgroup, warp 4 the producer, one thread of which
//     keeps a TMA ring of up to 8 stages full: the int8 box [64 k][128]
//     (128-byte swizzle, so a fragment's rows load from distinct banks)
//     and x's box [NR rows][64 k] (rows past M, and a padding stage past
//     K, read as zeros through the maps). Three blocks fit an SM (two at
//     32 and 64 rows, whose accumulators take the registers).
//   - The epilogue mode scales the f32 sums by the column's scale; the
//     prologue mode converts each weight to bf16(q * scale) as it builds
//     the fragment (the scales of the thread's 4 columns in registers).
//   - 128 columns do not fill 132 SMs at the seams' widths (wo: 32
//     blocks), so the plan splits K (up to 8 ways) until the blocks cover
//     the SMs; the split pass is launched as a programmatic dependent, so
//     its launch overlaps this kernel's tail.
//   tools/int8_matmul_parts.py compiles its conversions, products or loads
//   out (the INT8_SWAP_NO_* macros below; the outputs are then wrong).
//
// M > 64 (prefill, expert products): the warp-specialised wgmma body of
// grouped_matmul.cu, its consumers converting the weights between the loads
// and the products. A block of 3 warpgroups owns a 128 x 256 output tile.
//   - Warpgroup 0 (setmaxnreg 40): one thread keeps a TMA ring of 4 stages
//     full, guarded by full / empty mbarriers: x tiles [128 rows][64 k]
//     through a rank-3 bf16 map over [E, M, K] (128-byte swizzle), q tiles
//     [64 k][256] through a rank-3 int8 map over [E, K, N] (unswizzled
//     rows of 256 bytes). Rows past M and columns past N read as zeros.
//   - Warpgroups 1 and 2 (setmaxnreg 232) own 128 columns each, all 128
//     rows (two m64 halves). Each turns its columns of a landed int8 tile
//     into its own bf16 image, in the 128-byte-swizzled MN-major layout a
//     TMA load of a bf16 [K, N] matrix would have left (three images a
//     consumer): logic ops make each weight an f32 2^23 + (q + 128) (or
//     2^23 + 256 (q + 128)) and one subtraction (or fma) makes it q
//     exactly; the exact mode keeps its high half (q as bf16), the prologue
//     mode multiplies by the column's f32 scale (eight a thread, in
//     registers) and rounds. It converts stage s + 1 while its wgmma
//     m64n128k16 products of stages s - 1 and s run (x K-major, the
//     image through the transpose bit), fences the image into the async
//     proxy and meets its own warps at a named barrier: no barrier between
//     the two consumers. The scale (the epilogue mode) multiplies the f32
//     sums, one cast, masked bf16 stores.
//   - Why the consumers convert: each converted weight feeds 256
//     operations at BM 128, so the full bf16 rate needs ~17 conversions a
//     clock on each SM. A first version left conversion to warpgroup 0's
//     three idle warps (an image ring between them and the consumers):
//     at the expert shape their conversions alone took longer than the
//     products and the loads together. The consumers' eight warps have
//     the issue slots. tools/int8_matmul_parts.py times this body with
//     its conversions, products or loads compiled out (the INT8_WIDE_NO_*
//     macros below; their outputs are wrong by construction).
//   - Blocks walk the row tiles fastest, so the blocks in flight share a
//     weight tile through the 50 MB L2 and each weight byte leaves device
//     memory about once.
//   Left out, measured no faster on the H100 at the expert shape: separate
//   x and q rings (a q tile released once converted), 2-7 stages against
//   2-3 images, a persistent grid walking the tiles, a rolled conversion
//   loop; and, at every shape of the int8 paths, a 128-column tile.
//
// Split K (either body): each split writes its f32 partial sums to a
// scratch buffer [split, E, M, N], and a second small pass sums them in a
// fixed order, applies the epilogue scale and casts.

#include "hopper.cuh"      // mbarriers, TMA, wgmma, setmaxnreg, tensor maps
#include "int8_image.cuh"  // int8 tiles into bf16 images or swapped
                           // register fragments

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBK = 64;  // K depth of one stage (both bodies)

// The split-K epilogue: y[e, m, n] = bf16(sum over s of part[s, e, m, n],
// times scale[e, n] unless PROLOGUE), the splits summed in order.
template <bool PROLOGUE>
__global__ void __launch_bounds__(256)
int8_matmul_reduce(const float* __restrict__ part,
                   const float* __restrict__ scale, bf16* __restrict__ y,
                   int m, int n, int e_count, int split) {
  // A programmatic dependent of the swapped form (its launch overlaps
  // that kernel's tail): wait for the partials. A no-op otherwise.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t total = (size_t)e_count * m * n;
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 2;
  if (i >= total) return;
  float v0 = 0.f, v1 = 0.f;
  for (int s = 0; s < split; ++s) {
    const float2 p = *reinterpret_cast<const float2*>(part + s * total + i);
    v0 += p.x;
    v1 += p.y;
  }
  if (!PROLOGUE) {
    const int col = static_cast<int>(i % n);
    const size_t e = i / ((size_t)m * n);
    v0 *= scale[e * n + col];
    v1 *= scale[e * n + col + 1];
  }
  *reinterpret_cast<__nv_bfloat162*>(y + i) = __floats2bfloat162_rn(v0, v1);
}

// Launches the split-K epilogue pass after a split kernel (checking that
// kernel's launch first); `dependent`: as a programmatic dependent of it.
template <bool PROLOGUE>
int reduce(void* part, const void* scale, void* y, int e, int m, int n,
           int split, cudaStream_t st, bool dependent = false) {
  if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  const size_t pairs = (size_t)e * m * n / 2;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((pairs + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, int8_matmul_reduce<PROLOGUE>, static_cast<const float*>(part),
      static_cast<const float*>(scale), static_cast<bf16*>(y), m, n, e,
      split));
}

// ---------------------------------------------------------------------------
// M <= 64: the swapped form.
// ---------------------------------------------------------------------------

constexpr int kSwapCols = 128;              // weight columns of a block
constexpr int kSwapThreads = 160;           // a consumer warpgroup + a
                                            // producer warp
constexpr int kSwapQBox = kBK * kSwapCols;  // int8 box: 64 k x 128 columns
constexpr int kSwapRing = 64 * 1024;        // bytes of stages: 3 blocks an SM

// NR token rows (M rounded up to 8, 16, 32 or 64) as wgmma's N. Shared
// memory (byte offsets from a 1024-aligned base): STAGES stages of the
// int8 box then the x box (NR rows x 64 k, 128-byte swizzle: both start
// 1024-aligned), then the full and empty barriers.
template <int NR>
struct Swap {
  static constexpr int XBOX = NR * kRowBytes;
  static constexpr int STAGE = kSwapQBox + XBOX;
  static constexpr int STAGES = kSwapRing / STAGE < 8 ? kSwapRing / STAGE : 8;
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;
  // Blocks an SM runs at once: three, where their registers allow (the
  // accumulators of 32 and 64 rows do not).
  static constexpr int BLOCKS = NR <= 16 ? 3 : 2;
  static_assert(STAGES >= 2 && XBOX % 1024 == 0, "ring");
};

// x_map: [E, M, K] bf16 in 64 x NR x 1 swizzled boxes; q_map: [E, K, N]
// int8 in 128 x 64 x 1 swizzled boxes. Block (blockIdx.x, blockIdx.y):
// columns 128 blockIdx.x.., batch entry blockIdx.y / split, K split
// blockIdx.y % split. SPLIT as in int8_matmul_wide_kernel.
template <int NR, bool PROLOGUE, bool SPLIT>
__global__ void __launch_bounds__(kSwapThreads, Swap<NR>::BLOCKS)
int8_matmul_swap_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap q_map,
                        const float* __restrict__ scale,
                        bf16* __restrict__ y, float* __restrict__ part,
                        int m, int n, int k, int split) {
  using W = Swap<NR>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W::BARS);
  uint64_t* empty = full + W::STAGES;

  const int n0 = blockIdx.x * kSwapCols;
  const int e = blockIdx.y / split, s = blockIdx.y % split;
  const int e_count = gridDim.y / split;
  const int k_len = k / split, k_base = s * k_len;
  const int n_steps = k_len / kBK;
  // The consumers take stages in pairs (two register buffers): an odd
  // count gets one more stage, loaded from past K, where every box reads
  // as zeros.
  const int steps = (n_steps + 1) & ~1;

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
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&q_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&x_map))
                   : "memory");
      for (int step = 0; step < steps; ++step) {
        const int st = step % W::STAGES;
        mbar_wait(&empty[st], ((step / W::STAGES) & 1) ^ 1);
#ifdef INT8_SWAP_NO_LOADS
        mbar_arrive(&full[st]);
#else
        unsigned char* b = smem + st * W::STAGE;
        const int k0 = step < n_steps ? k_base + step * kBK : k;
        mbar_expect_tx(&full[st], W::STAGE);
        tma_load(b, &q_map, &full[st], n0, k0, e);
        tma_load(b + kSwapQBox, &x_map, &full[st], k0, 0, e);
#endif
      }
    }
    return;
  }

  // The consumer warpgroup owns the block's 128 columns as two m64 blocks:
  // in block mb, thread (warp, g8) holds columns bx and bx + 1, bx = 64 mb
  // + 16 warp + 2 g8 (int8_image.cuh, swap_fragments), and (PROLOGUE)
  // their scales.
  const int g8 = lane >> 2, t = lane & 3;
  int bx[2];
  float sc[2][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    bx[mb] = 64 * mb + 16 * warp + 2 * g8;
    const int col = n0 + bx[mb];
    const float s0 = PROLOGUE && col < n ? scale[(size_t)e * n + col] : 0.f;
    const float s1 =
        PROLOGUE && col + 1 < n ? scale[(size_t)e * n + col + 1] : 0.f;
    sc[mb][0] = sc[mb][1] = s0;
    sc[mb][2] = sc[mb][3] = s1;
  }
  float acc[2][NR / 2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc[mb][i] = 0.f;

  // One stage: its fragments into fr, its 8 products issued, then the
  // previous stage's products waited for and that stage released. No
  // conditional product, and the accumulators are touched only after the
  // last wait: either would make ptxas serialise the products.
  auto stage = [&](int step, uint32_t (&fr)[2][4][4]) {
    const int st = step % W::STAGES;
    mbar_wait(&full[st], (step / W::STAGES) & 1);
    const unsigned char* base = smem + st * W::STAGE;
#ifndef INT8_SWAP_NO_CONVERT
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
      swap_fragments<PROLOGUE>(base, bx[mb], t, sc[mb], fr[mb]);
#endif
    fence_regs(fr[0]);
    fence_regs(fr[1]);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#ifndef INT8_SWAP_NO_PRODUCTS
    const uint32_t xa = smem_u32(base + kSwapQBox);
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_kmajor<NR>(acc[mb], fr[mb][kk], kmajor_desc(xa + kk * 32));
#endif
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (step > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % W::STAGES]);
  };
  // Two register buffers: a stage's fragments are written only after the
  // products that read the same buffer two stages before are done.
  uint32_t fa[2][4][4], fb[2][4][4];
  for (int step = 0; step < steps; step += 2) {
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
  // The split pass may launch now; it waits for this grid's end before it
  // reads the partials.
  if (SPLIT) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // acc[mb][4 j + q]: token row 8 j + 2 t + (q & 1), column bx + (q >> 1).
  const float* se = scale + (size_t)e * n;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    const int col = n0 + bx[mb];
    if (col >= n) continue;  // n % 16 == 0: col < n means col + 1 < n too
    float s0 = 1.f, s1 = 1.f;
    if (!PROLOGUE && !SPLIT) {
      s0 = se[col];
      s1 = se[col + 1];
    }
#pragma unroll
    for (int j = 0; j < NR / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 8 * j + 2 * t + h;
        if (row >= m) continue;
        const float v0 = acc[mb][4 * j + h], v1 = acc[mb][4 * j + 2 + h];
        if (SPLIT) {
          *reinterpret_cast<float2*>(
              part + (((size_t)s * e_count + e) * m + row) * n + col) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              y + ((size_t)e * m + row) * n + col) =
              __floats2bfloat162_rn(v0 * s0, v1 * s1);
        }
      }
  }
}

template <int NR, bool PROLOGUE>
int launch_swap(const void* x, const void* q, const void* scale, void* y,
                void* part, int e, int m, int n, int k, int split,
                long long ldq, long long sq, cudaStream_t st) {
  using W = Swap<NR>;
  auto kernel = split > 1 ? int8_matmul_swap_kernel<NR, PROLOGUE, true>
                          : int8_matmul_swap_kernel<NR, PROLOGUE, false>;
  // Raised before the tensor maps are encoded: this runtime call binds the
  // device's context to the calling thread, which the driver's encoder
  // needs.
  if (int rc = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM)))
    return rc;
  CUtensorMap xm, qm;
  {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m),
                                static_cast<cuuint64_t>(e)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k) * 2,
                                   static_cast<cuuint64_t>(m) * k * 2};
    const cuuint32_t box[3] = {kBK, NR, 1};
    if (int rc = bf16_tensor_map(&xm, x, 3, dims, strides, box)) return rc;
  }
  {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(e)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ldq),
                                   static_cast<cuuint64_t>(sq)};
    const cuuint32_t box[3] = {kSwapCols, kBK, 1};
    if (int rc = tensor_map_of(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                               CU_TENSOR_MAP_SWIZZLE_128B, q, 3, dims,
                               strides, box))
      return rc;
  }
  const dim3 grid((n + kSwapCols - 1) / kSwapCols, e * split);
  kernel<<<grid, kSwapThreads, W::SMEM, st>>>(
      xm, qm, static_cast<const float*>(scale), static_cast<bf16*>(y),
      static_cast<float*>(part), m, n, k, split);
  if (split > 1)
    return reduce<PROLOGUE>(part, scale, y, e, m, n, split, st, true);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// M > 64: the warp-specialised wgmma body.
// ---------------------------------------------------------------------------

constexpr int kWideRows = 128;                // output rows of a block
constexpr int kWideCols = 256;                // output columns of a block
constexpr int kWN = kWideCols / 2;            // a consumer's columns
constexpr int kXBox = kWideRows * kRowBytes;  // x tile: 128 rows x 64 k
constexpr int kImgBox = kBK * kRowBytes;      // image box: 64 k x 64 columns

// Shared memory (byte offsets from a 1024-aligned base): kStages stages of
// the x tile then the int8 q tile [64][256]; each consumer's kImages bf16
// images of its 128 columns (two boxes each); the full and empty barriers.
// A stage is loaded for its conversion, a step before its products, and
// released two steps after them: a ring of fewer than 4 would wait on
// itself, and 4 is what fits.
constexpr int kImages = 3;  // two stages' products in flight, one converting
constexpr int kStages = 4;
constexpr int kStage = kXBox + kBK * kWideCols;
constexpr int kImg = (kWN / 64) * kImgBox;    // one consumer's image
constexpr int kImg0 = kStages * kStage;       // consumer c, image i:
                                              // kImg0 + (kImages c + i) kImg
constexpr int kBars = kImg0 + 2 * kImages * kImg;
constexpr int kWideSmem = kBars + 2 * kStages * 8 + 1024;
static_assert(kMinSmem <= kWideSmem && kWideSmem <= 232448, "shared memory");

// One stage's products of a consumer: its 128 rows (two m64 halves) by its
// 128 columns, k16 by k16; A (x) K-major, B (the image) MN-major through
// the transpose bit.
__device__ __forceinline__ void wide_products(float (&acc)[2][kWN / 2],
                                              uint32_t a, uint32_t b) {
#ifndef INT8_WIDE_NO_PRODUCTS
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t db = mnmajor_desc(b + kk * 16 * kRowBytes, kImgBox);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t da = kmajor_desc(a + h * 64 * kRowBytes + kk * 32);
      wgmma_ss_n128<0, 1>(acc[h], da, db, 1);
    }
  }
#endif
}

// x_map: [E, M, K] bf16 in 64 x 128 x 1 boxes; q_map: [E, K, N] int8 in
// 256 x 64 x 1 boxes. Block (blockIdx.x, blockIdx.y): row tile
// blockIdx.x % m_tiles, column tile blockIdx.x / m_tiles, batch entry
// blockIdx.y / split, K split blockIdx.y % split. SPLIT as in
// int8_matmul_kernel.
template <bool PROLOGUE, bool SPLIT>
__global__ void __launch_bounds__(kWgThreads, 1)
int8_matmul_wide_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap q_map,
                        const float* __restrict__ scale,
                        bf16* __restrict__ y, float* __restrict__ part,
                        int m, int n, int k, int split) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* empty = full + kStages;

  const int m_tiles = (m + kWideRows - 1) / kWideRows;
  const int m0 = (blockIdx.x % m_tiles) * kWideRows;
  const int n0 = (blockIdx.x / m_tiles) * kWideCols;
  const int e = blockIdx.y / split, s = blockIdx.y % split;
  const int e_count = gridDim.y / split;
  const int k_len = k / split, k_base = s * k_len;
  const int n_steps = k_len / kBK;

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
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % kStages;
        mbar_wait(&empty[st], ((step / kStages) & 1) ^ 1);
#ifdef INT8_WIDE_NO_LOADS
        mbar_arrive(&full[st]);
#else
        unsigned char* a = smem + st * kStage;
        const int k0 = k_base + step * kBK;
        mbar_expect_tx(&full[st], kStage);
        tma_load(a, &x_map, &full[st], k0, m0, e);
        tma_load(a + kXBox, &q_map, &full[st], n0, k0, e);
#endif
      }
    }
    return;
  }

  // Consumer warpgroup c owns output columns n0 + kWN c .. + kWN - 1 of all
  // 128 rows, and converts those columns of each int8 tile itself: thread
  // tid keeps one group of 8 columns (and, in the prologue mode, their
  // scales) and converts every 128 / G-th row of it.
  setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int c0 = n0 + kWN * c;
  constexpr int G = kWN / 8, RP = 128 / G;
  const int grp = tid % G, rp = tid / G;
  float cs[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int col = c0 + grp * 8 + u;
    cs[u] = PROLOGUE && col < n ? scale[(size_t)e * n + col] : 0.f;
  }
  // The group's 16 bytes of an image row: box grp / 8, chunk grp % 8,
  // permuted by the 128-byte swizzle (chunk ^ row % 8).
  const int img_col = (grp / 8) * kImgBox, chunk = grp % 8;
  unsigned char* images = smem + kImg0 + kImages * c * kImg;

  // Converts stage `step`'s int8 columns into image step % kImages, fences
  // the writes into the async proxy and meets the warpgroup's other warps.
  auto convert = [&](int step) {
    const unsigned char* q8 =
        smem + (step % kStages) * kStage + kXBox + kWN * c + grp * 8;
    unsigned char* img = images + (step % kImages) * kImg + img_col;
#ifndef INT8_WIDE_NO_CONVERT
    convert_rows<PROLOGUE, RP>(q8, kWideCols, img, chunk, rp, cs);
#endif
    fence_proxy_async();
    named_sync(1 + c, 128);
  };

  float acc[2][kWN / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < kWN / 2; ++i) acc[h][i] = 0.f;

  if (n_steps > 0) {
    mbar_wait(&full[0], 0);
    convert(0);
  }
  // No conditional product and no touch of the accumulators while
  // products are in flight: either makes ptxas wait for them. Columns past
  // N (zero-filled, converted to zeros) and an m64 half past M cost
  // products but are not stored.
  for (int step = 0; step < n_steps; ++step) {
    const int st = step % kStages;
    wgmma_fence();
    wide_products(acc, smem_u32(smem + st * kStage),
                  smem_u32(images + (step % kImages) * kImg));
    wgmma_commit();
    // Up to two stages' products in flight: the one before the previous is
    // done, so its x tile and its image are free, and the next stage
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
  if (c0 >= n) return;

  const int g8 = lane >> 2, t = lane & 3;
  const float* se = scale + (size_t)e * n;
#pragma unroll
  for (int j = 0; j < kWN / 8; ++j) {
    const int col = c0 + j * 8 + 2 * t;
    if (col >= n) continue;  // n % 16 == 0: col < n means col + 1 < n too
    float s0 = 1.f, s1 = 1.f;
    if (!PROLOGUE && !SPLIT) {
      s0 = se[col];
      s1 = se[col + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + 64 * h + warp * 16 + g8 + 8 * hh;
        if (row >= m) continue;
        const float v0 = acc[h][4 * j + 2 * hh];
        const float v1 = acc[h][4 * j + 2 * hh + 1];
        if (SPLIT) {
          *reinterpret_cast<float2*>(
              part + (((size_t)s * e_count + e) * m + row) * n + col) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              y + ((size_t)e * m + row) * n + col) =
              __floats2bfloat162_rn(v0 * s0, v1 * s1);
        }
      }
  }
}

template <bool PROLOGUE>
int launch_wide(const void* x, const void* q, const void* scale, void* y,
                void* part, int e, int m, int n, int k, int split,
                long long ldq, long long sq, cudaStream_t st) {
  const long long blocks = (long long)((m + kWideRows - 1) / kWideRows) *
                           ((n + kWideCols - 1) / kWideCols);
  if (blocks > 0x7fffffffLL) return -1;
  auto kernel = split > 1 ? int8_matmul_wide_kernel<PROLOGUE, true>
                          : int8_matmul_wide_kernel<PROLOGUE, false>;
  // Raised before the tensor maps are encoded: this runtime call binds the
  // device's context to the calling thread, which the driver's encoder
  // needs.
  if (int rc = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem)))
    return rc;
  CUtensorMap xm, qm;
  {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m),
                                static_cast<cuuint64_t>(e)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k) * 2,
                                   static_cast<cuuint64_t>(m) * k * 2};
    const cuuint32_t box[3] = {kBK, kWideRows, 1};
    if (int rc = bf16_tensor_map(&xm, x, 3, dims, strides, box)) return rc;
  }
  {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(e)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ldq),
                                   static_cast<cuuint64_t>(sq)};
    const cuuint32_t box[3] = {kWideCols, kBK, 1};
    if (int rc = int8_tensor_map(&qm, q, 3, dims, strides, box)) return rc;
  }
  const dim3 grid(static_cast<unsigned>(blocks), e * split);
  kernel<<<grid, kWgThreads, kWideSmem, st>>>(
      xm, qm, static_cast<const float*>(scale), static_cast<bf16*>(y),
      static_cast<float*>(part), m, n, k, split);
  if (split > 1) return reduce<PROLOGUE>(part, scale, y, e, m, n, split, st);
  return static_cast<int>(cudaGetLastError());
}

template <bool PROLOGUE>
int dispatch(const void* x, const void* q, const void* scale, void* y,
             void* part, int e, int m, int n, int k, int split, long long ldq,
             long long sq, cudaStream_t st) {
  if (m <= 8) return launch_swap<8, PROLOGUE>(x, q, scale, y, part, e, m, n,
                                              k, split, ldq, sq, st);
  if (m <= 16) return launch_swap<16, PROLOGUE>(x, q, scale, y, part, e, m,
                                                n, k, split, ldq, sq, st);
  if (m <= 32) return launch_swap<32, PROLOGUE>(x, q, scale, y, part, e, m,
                                                n, k, split, ldq, sq, st);
  if (m <= 64) return launch_swap<64, PROLOGUE>(x, q, scale, y, part, e, m,
                                                n, k, split, ldq, sq, st);
  if (split == 8) return -1;
  return launch_wide<PROLOGUE>(x, q, scale, y, part, e, m, n, k, split, ldq,
                               sq, st);
}

}  // namespace

// x bf16 [e, m, k], q int8 [e, k, n], scale f32 [e, n] -> y bf16 [e, m, n];
// part: f32 scratch [split, e, m, n] when split > 1 (else unused).
// prologue: 0 scales the f32 sum (SCALE_EPILOGUE), 1 stages bf16(q * scale)
// (SCALE_PROLOGUE). q's rows lie ldq bytes apart and its entries sq bytes
// apart (a column block of a wider weight, such as a tensor shard's, read
// as it lies; multiples of 16). Returns -1 for shapes the kernel does not
// take.
extern "C" int int8_matmul_strided(const void* x, const void* q,
                                   const void* scale, void* y, void* part,
                                   int e, int m, int n, int k, int split,
                                   int prologue, long long ldq, long long sq,
                                   void* stream) {
  if (e <= 0 || m <= 0 || n <= 0 || n % 16 || k <= 0 ||
      (split != 1 && split != 2 && split != 4 && split != 8) ||
      k % (kBK * split) ||
      (split > 1 && part == nullptr) || e * split > 65535 || ldq < n ||
      ldq % 16 || sq % 16 || (e > 1 && sq < (long long)k * ldq))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return prologue ? dispatch<true>(x, q, scale, y, part, e, m, n, k, split,
                                   ldq, sq, st)
                  : dispatch<false>(x, q, scale, y, part, e, m, n, k, split,
                                    ldq, sq, st);
}

// The packed form of int8_matmul_strided: q [e, k, n] contiguous.
extern "C" int int8_matmul(const void* x, const void* q, const void* scale,
                           void* y, void* part, int e, int m, int n, int k,
                           int split, int prologue, void* stream) {
  return int8_matmul_strided(x, q, scale, y, part, e, m, n, k, split,
                             prologue, n, (long long)k * n, stream);
}
