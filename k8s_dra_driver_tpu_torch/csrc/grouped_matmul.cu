// Grouped matrix products for Hopper (sm_90a): the two kernels behind the
// backward of the fused MoE dispatch pipeline and behind the primitive
// dispatch path in both directions.
//
// Replaces megablox (jax.experimental.pallas.ops.tpu.megablox), which the
// JAX package reaches from:
//   gmm  <- k8s_dra_driver_tpu/ops/moe_dispatch.py::grouped_matmul (the gmm
//           call at :407)
//   tgmm <- k8s_dra_driver_tpu/ops/moe_dispatch.py::grouped_weight_grad (the
//           tgmm call at :437)
//
// Groups partition the rows by cumulative sizes (lax.ragged_dot's contract):
// group g holds rows [start_g, start_g + size_g), start_g the sum of the sizes
// before it; the sizes may leave rows past the last group.
//   gmm:  lhs [rows, K] bf16; rhs [E, K, N] bf16, either as stored (N
//         contiguous) or the transposed view of an [E, N, K] tensor (K
//         contiguous: a flag, not a copy); group_sizes [E] int32
//         -> out [rows, N] bf16, out[r] = lhs[r] . rhs[g(r)] summed in f32 and
//         rounded once; rows past the last group exactly 0.
//   tgmm: lhs [rows, K] bf16, rhs [rows, N] bf16, group_sizes [E] int32
//         -> out [E, K, N] f32, out[e] = lhs_e^T . rhs_e over group e's rows;
//         an empty group writes zeros.
//
// What bounds them on the H100. In the MoE backward at the Mixtral-8x7B
// widths (8192 tokens, top 2: 16384 live rows of r_pad 17408, H 4096, M 14336)
// each call does 2 * 16384 * 4096 * 14336 = 1.9e12 operations (the w_down
// products) or twice that (the gate/up products) on 0.94 or 1.88 GB of expert
// weights: 2-4 ms at 989 TFLOP/s against 0.3-0.6 ms for the bytes at 3.35
// TB/s (tgmm's f32 output, 1.9-3.8 GB, is 0.6-1.1 ms of writes). Bound by
// operations, so every product is a wgmma: only wgmma reaches the tensor
// cores' full rate.
//
// Design: one warp-specialised GEMM body for both kernels, the shape of K4
// and K5 (the Hopper pieces come from hopper.cuh; the ring, the raster, one
// stage's products and the tensor maps from grouped_gemm.cuh, which the
// fused MoE dispatch kernels K7 and K8 share).
//   - A block of 3 warpgroups owns a 128 x BN output tile (BN 256, 128 or 64,
//     the widest that divides N). Warpgroup 0 is the producer: one thread
//     starts every TMA load, setmaxnreg leaves it 40 registers. Warpgroups 1
//     and 2 are consumers of 64 output rows each (232 registers; BN / 2 f32
//     accumulators a thread).
//   - The contracted axis goes through a ring of 4-8 stages of (A, B) tiles,
//     64 deep, in 128-byte swizzled boxes of 64 columns, guarded by full and
//     empty mbarriers: TMA completes `full`; each consumer warp arrives on
//     `empty` once wgmma.wait_group shows its products have read the stage.
//     A consumer keeps one stage's products in flight while it waits for
//     the next stage.
//   - Every product is wgmma m64n{BN}k16 with both operands in shared memory
//     as stored, no staged transpose: gmm's A (lhs) is K-major; its B is
//     MN-major as stored [E, K, N] (the descriptor's transpose bit) or K-major
//     as the transposed view of [E, N, K]. tgmm contracts over rows, so both
//     A (lhs^T: K contiguous) and B (rhs: N contiguous) are MN-major.
//   - Expert weights come through rank-3 tensor maps over [E, K, N] (or
//     [E, N, K]), so a box never reaches into the next expert; row operands
//     through rank-2 maps over [rows, K] / [rows, N]. TMA's zero fill past
//     the tensor's edge covers rows past `rows` and a 32-column tail of K
//     (gmm takes K in steps of 32).
//   gmm: one block per (row tile of 128, group) intersection and column
//     tile. Each block reads the prefix sums of group_sizes itself (no host
//     sync), so any sizes work, aligned or not. A tile that straddles two
//     groups is loaded whole once per group, each visit multiplying by its
//     group's weights and storing only its group's rows (masked register
//     stores), so no row is written twice. The items past the intersections
//     are the row tiles from the one holding the first row past the last
//     group on, and write those rows' zeros. Intersections and tail tiles
//     together never exceed n_row_tiles + E, the grid's item count; items
//     past them return at once. The dispatch plan's groups are tile-aligned,
//     so there each row tile belongs to exactly one group.
//   tgmm: one block per (K tile of 128, N tile, group); it loops over its
//     group's rows as the contracted axis, 64 rows a stage from the group's
//     first row (any row), so nothing is carried between blocks and no
//     atomics are needed. The last stage of a group can hold rows of the
//     next group or past the last one, which TMA cannot clip (it clips only
//     at the tensor's edge): the consumers zero those whole 128-byte rows of
//     every box of the stage (the swizzle permutes 16-byte chunks within a
//     row only), fence the writes into the async proxy and meet at a named
//     barrier before the stage's products. An empty group writes zeros.
// Blocks walk the output tiles in groups of 8 row tiles (gmm) or 8 K tiles
// (tgmm) per column sweep, so the operands the blocks in flight share stay in
// the 50 MB L2 instead of being re-read from device memory.
//
// Left out: a persistent grid (one block an SM walking the tiles, the ring
// running on from tile to tile so the next tile loads while this one is
// stored) measured no faster on the H100 at the MoE backward's shapes; a
// TMA-store epilogue; clusters whose blocks share an operand tile by TMA
// multicast (each stage reads 48 KB from L2 for 4.2 MFLOP of products).
//
// Rounding. The operands are bf16. In the MoE backward the SwiGLU gradient and
// the gated down-projection cotangent (f32 there) are rounded to bf16 before
// tgmm takes them, where the JAX package's off-TPU fallback keeps them f32.

#include "grouped_gemm.cuh"  // ring, raster, stage products, tensor maps

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kGmm = 0, kTgmm = 1;

// gmm (KIND kGmm): a_map over lhs [rows, K] in 64 x 128-row boxes; b_map
// over rhs [E, K, N] in 64 x 64 x 1 boxes, or (B_KMAJOR) over [E, N, K] in
// 64 x BN x 1 boxes; out bf16 [rows, N].
// tgmm (KIND kTgmm): a_map over lhs [rows, K], b_map over rhs [rows, N],
// both in 64 x 64-row boxes; out f32 [E, K, N].
template <int KIND, int BN, bool B_KMAJOR>
__global__ void __launch_bounds__(kWgThreads, 1)
grouped_kernel(const __grid_constant__ CUtensorMap a_map,
               const __grid_constant__ CUtensorMap b_map,
               const int32_t* __restrict__ sizes, void* __restrict__ out,
               int rows, int kdim, int ndim, int n_groups, int n_items) {
  using R = Ring<BN>;
  constexpr int TA = KIND == kTgmm ? 1 : 0;
  constexpr int TB = B_KMAJOR ? 0 : 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BARS);
  uint64_t* empty = full + R::STAGES;

  // The block's work: output rows [m0, m0 + 128) x columns [c0, c0 + BN);
  // gmm stores rows [lo, hi) of group `group`; tgmm contracts over rows
  // [lo, hi) of group `group`. Every thread walks the same prefix sums.
  int m0, c0, group = -1, lo = 0, hi = 0, n_steps;
  if constexpr (KIND == kGmm) {
    int item, col;
    swizzle(blockIdx.x, n_items, ndim / BN, item, col);
    c0 = col * BN;
    int tile = 0, start = 0;
    for (int g = 0; g < n_groups; ++g) {
      const int size = max(sizes[g], 0);
      const int s = min(start, rows), e = min(start + size, rows);
      const int n = e > s ? (e - 1) / kRowTile - s / kRowTile + 1 : 0;
      if (item < n) {
        group = g;
        tile = s / kRowTile + item;
        lo = max(s, tile * kRowTile);
        hi = min(e, tile * kRowTile + kRowTile);
        break;
      }
      item -= n;
      start += size;
    }
    if (group < 0) {
      // Past the intersections: item-th tile from the one holding the first
      // row past the last group; its rows past the groups are zeros.
      const int total = min(start, rows);
      tile = total / kRowTile + item;
      lo = max(total, tile * kRowTile);
      hi = min(rows, tile * kRowTile + kRowTile);
      bf16* o = static_cast<bf16*>(out);
      for (int i = threadIdx.x; i < (hi - lo) * (BN / 8); i += kWgThreads) {
        const int r = lo + i / (BN / 8), c = c0 + (i % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(o + (size_t)r * ndim + c) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      return;
    }
    m0 = tile * kRowTile;
    n_steps = (kdim + kDepth - 1) / kDepth;
  } else {
    int kt, nt;
    swizzle(blockIdx.x, (kdim + kRowTile - 1) / kRowTile, ndim / BN, kt, nt);
    m0 = kt * kRowTile;
    c0 = nt * BN;
    group = blockIdx.y;
    int start = 0;
    for (int g = 0; g < group; ++g) start += max(sizes[g], 0);
    lo = min(start, rows);
    hi = min(start + max(sizes[group], 0), rows);
    n_steps = hi > lo ? (hi - lo + kDepth - 1) / kDepth : 0;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % R::STAGES;
        mbar_wait(&empty[st], ((step / R::STAGES) & 1) ^ 1);
        unsigned char* a = smem + st * R::STAGE;
        unsigned char* b = a + R::A;
        if constexpr (KIND == kGmm) {
          const int k0 = step * kDepth;
          mbar_expect_tx(&full[st], R::STAGE);
          tma_load(a, &a_map, &full[st], k0, m0);
          if constexpr (B_KMAJOR) {
            tma_load(b, &b_map, &full[st], k0, c0, group);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(b + j * kBox, &b_map, &full[st], c0 + 64 * j, k0,
                       group);
          }
        } else {
          // The second A box lies wholly past K when K % 128 == 64: not
          // loaded (its consumer's rows are not stored).
          const int r0 = lo + step * kDepth;
          const int a_boxes = m0 + 64 < kdim ? 2 : 1;
          mbar_expect_tx(&full[st], a_boxes * kBox + BN * kRowBytes);
          for (int h = 0; h < a_boxes; ++h)
            tma_load(a + h * kBox, &a_map, &full[st], m0 + 64 * h, r0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(b + j * kBox, &b_map, &full[st], c0 + 64 * j, r0);
        }
      }
    }
  } else {
    // Consumer warpgroup c owns output rows m0 + 64 c .. + 63.
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128;  // 0..255 over both consumers
    const int warp = (threadIdx.x % 128) >> 5, lane = threadIdx.x & 31;

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int step = 0; step < n_steps; ++step) {
      const int st = step % R::STAGES;
      mbar_wait(&full[st], (step / R::STAGES) & 1);
      unsigned char* a = smem + st * R::STAGE;
      if constexpr (KIND == kTgmm) {
        // Rows of the stage past the group contribute nothing: zero them
        // in every box (2 of A, BN / 64 of B, contiguous).
        const int valid = hi - (lo + step * kDepth);
        if (valid < kDepth) {
          constexpr int BOXES = 2 + BN / 64;
          const int chunks = (kDepth - valid) * (kRowBytes / 16);
          for (int i = tid; i < BOXES * chunks; i += 256) {
            const int bx = i / chunks, rem = i % chunks;
            *reinterpret_cast<uint4*>(a + bx * kBox +
                                      (valid + rem / 8) * kRowBytes +
                                      (rem % 8) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          fence_proxy_async();
          named_sync(1, 256);
        }
      }
      // Consumer c's A: rows 64 c.. of gmm's 128-row box, or tgmm's box c
      // (its 64 output rows of K): 8 KB on either way.
      const uint32_t a_addr = smem_u32(a) + c * kBox;
      const uint32_t b_addr = smem_u32(a + R::A);
      fence_regs(acc);
      wgmma_fence();
      stage_products<BN, TA, TB>(acc, a_addr, b_addr);
      wgmma_commit();
      // The previous stage's products are done: release it.
      wgmma_wait<1>();
      fence_regs(acc);
      if (step > 0 && lane == 0)
        mbar_arrive(&empty[(step - 1) % R::STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int g8 = lane >> 2, t = lane & 3;
    const int r_lo = m0 + 64 * c + warp * 16 + g8, r_hi = r_lo + 8;
    if constexpr (KIND == kGmm) {
      bf16* o = static_cast<bf16*>(out);
      const bool st_lo = r_lo >= lo && r_lo < hi;
      const bool st_hi = r_hi >= lo && r_hi < hi;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c0 + j * 8 + 2 * t;
        if (st_lo)
          *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r_lo * ndim + col) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        if (st_hi)
          *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r_hi * ndim + col) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    } else {
      float* o = static_cast<float*>(out) + (size_t)group * kdim * ndim;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c0 + j * 8 + 2 * t;
        if (r_lo < kdim)
          *reinterpret_cast<float2*>(o + (size_t)r_lo * ndim + col) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
        if (r_hi < kdim)
          *reinterpret_cast<float2*>(o + (size_t)r_hi * ndim + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// Raises the kernel's shared-memory limit. Called before the tensor maps
// are encoded: this runtime call binds the device's context to the calling
// thread, which the driver's encoder needs (autograd runs a backward on a
// thread of its own, where no CUDA call may have run yet).
template <int KIND, int BN, bool B_KMAJOR>
int prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      grouped_kernel<KIND, BN, B_KMAJOR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<BN>::BYTES));
}

template <int BN, bool B_KMAJOR>
int launch_gmm(const void* lhs, const void* rhs, const void* sizes, void* out,
               int rows, int kdim, int ndim, int n_groups, long long ld,
               long long es, cudaStream_t st) {
  const long long n_items = (rows + kRowTile - 1) / kRowTile + n_groups;
  const long long blocks = n_items * (ndim / BN);
  if (blocks > 0x7fffffffLL) return -1;
  if (int rc = prepare<kGmm, BN, B_KMAJOR>()) return rc;
  CUtensorMap am, bm;
  if (int rc = matrix_map(&am, lhs, rows, kdim, kRowTile)) return rc;
  if (int rc = B_KMAJOR
                   ? experts_map(&bm, rhs, n_groups, ndim, kdim, BN, ld, es)
                   : experts_map(&bm, rhs, n_groups, kdim, ndim, 64, ld, es))
    return rc;
  grouped_kernel<kGmm, BN, B_KMAJOR>
      <<<static_cast<unsigned>(blocks), kWgThreads, Ring<BN>::BYTES, st>>>(
          am, bm, static_cast<const int32_t*>(sizes), out, rows, kdim, ndim,
          n_groups, static_cast<int>(n_items));
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_tgmm(const void* lhs, const void* rhs, const void* sizes,
                void* out, int rows, int kdim, int ndim, int n_groups,
                cudaStream_t st) {
  const long long tiles =
      (long long)((kdim + kRowTile - 1) / kRowTile) * (ndim / BN);
  if (tiles > 0x7fffffffLL) return -1;
  if (int rc = prepare<kTgmm, BN, false>()) return rc;
  CUtensorMap am, bm;
  if (int rc = matrix_map(&am, lhs, rows, kdim, kDepth)) return rc;
  if (int rc = matrix_map(&bm, rhs, rows, ndim, kDepth)) return rc;
  const dim3 grid(static_cast<unsigned>(tiles), n_groups);
  grouped_kernel<kTgmm, BN, false><<<grid, kWgThreads, Ring<BN>::BYTES, st>>>(
      am, bm, static_cast<const int32_t*>(sizes), out, rows, kdim, ndim,
      n_groups, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [rows, n] = lhs [rows, k] times rhs [E, k, n] per group; rhs stored
// [E, k, n], or [E, n, k] when rhs_transposed, its rows ld_rhs elements
// apart and its experts e_stride_rhs apart (0: packed; a strided view such
// as a tensor shard's half of a gate/up stack, read as it lies). k in steps
// of 32, n of 64.
extern "C" int grouped_matmul(const void* lhs, const void* rhs,
                              const void* group_sizes, void* out, int rows,
                              int k, int n, int n_groups, int rhs_transposed,
                              long long ld_rhs, long long e_stride_rhs,
                              void* stream) {
  if (rows < 0 || k <= 0 || k % 32 || n <= 0 || n % 64 || n_groups <= 0 ||
      ld_rhs < 0 || e_stride_rhs < 0)
    return -1;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ld = ld_rhs, es = e_stride_rhs;
  if (rhs_transposed) {
    if (n % 256 == 0)
      return launch_gmm<256, true>(lhs, rhs, group_sizes, out, rows, k, n,
                                   n_groups, ld, es, st);
    if (n % 128 == 0)
      return launch_gmm<128, true>(lhs, rhs, group_sizes, out, rows, k, n,
                                   n_groups, ld, es, st);
    return launch_gmm<64, true>(lhs, rhs, group_sizes, out, rows, k, n,
                                n_groups, ld, es, st);
  }
  if (n % 256 == 0)
    return launch_gmm<256, false>(lhs, rhs, group_sizes, out, rows, k, n,
                                  n_groups, ld, es, st);
  if (n % 128 == 0)
    return launch_gmm<128, false>(lhs, rhs, group_sizes, out, rows, k, n,
                                  n_groups, ld, es, st);
  return launch_gmm<64, false>(lhs, rhs, group_sizes, out, rows, k, n,
                               n_groups, ld, es, st);
}

// out [E, k, n] f32 = lhs_e^T [k, rows_e] times rhs_e [rows_e, n] per group.
// k and n in steps of 64.
extern "C" int grouped_weight_grad(const void* lhs, const void* rhs,
                                   const void* group_sizes, void* out,
                                   int rows, int k, int n, int n_groups,
                                   void* stream) {
  if (rows < 0 || k <= 0 || k % 64 || n <= 0 || n % 64 || n_groups <= 0 ||
      n_groups > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0)  // every group empty; no tensor map over 0 rows
    return static_cast<int>(cudaMemsetAsync(
        out, 0, (size_t)n_groups * k * n * sizeof(float), st));
  if (n % 256 == 0)
    return launch_tgmm<256>(lhs, rhs, group_sizes, out, rows, k, n, n_groups,
                            st);
  if (n % 128 == 0)
    return launch_tgmm<128>(lhs, rhs, group_sizes, out, rows, k, n, n_groups,
                            st);
  return launch_tgmm<64>(lhs, rhs, group_sizes, out, rows, k, n, n_groups,
                         st);
}
