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
// TB/s. Bound by operations, so every product runs on the tensor cores.
//
// Design. Both kernels are one tiled GEMM body: a block of 8 warps owns a 128 x
// 128 (or 64-wide) output tile and walks the contracted axis in stages of 32,
// fed by a 4-deep cp.async ring; each warp multiplies with mma.sync.m16n8k16
// (bf16 in, f32 accumulate) from fragments that ldmatrix reads out of shared
// memory (.trans where the operand's contracted axis is not contiguous:
// megablox's transposed operands cost no copy). wgmma and TMA are later steps.
// Shared-memory rows are padded by 8 bf16, so the 8 rows of every ldmatrix
// phase fall in distinct banks.
//   gmm: one block per (row tile of 128, group) intersection and column tile.
//     Megablox walks group metadata built on the host; here each block reads
//     the prefix sums of group_sizes itself (no host sync), so any sizes work,
//     aligned or not. A tile that straddles two groups is visited once per
//     group, each visit loading and storing only its group's rows, so no row
//     is written twice. The items past the intersections are the row tiles
//     from the one holding the first row past the last group on, and write
//     those rows' zeros. Intersections and tail tiles together never exceed
//     n_row_tiles + E, the grid's item count; items past them return at once.
//     The dispatch plan's groups are tile-aligned, so there each row tile
//     belongs to exactly one group.
//   tgmm: one block per (K tile, N tile, group); it loops over its group's
//     rows as the contracted axis, so nothing is carried between blocks and
//     no atomics are needed. Both operands have rows as the contracted axis:
//     lhs^T is read with ldmatrix.trans.
// Blocks walk the output tiles in groups of 8 row tiles (gmm) or 8 K tiles
// (tgmm) per column sweep, so the operands the blocks in flight share stay in
// the 50 MB L2 instead of being re-read from device memory.
//
// Rounding. The operands are bf16. In the MoE backward the SwiGLU gradient and
// the gated down-projection cotangent (f32 there) are rounded to bf16 before
// tgmm takes them, where the JAX package's off-TPU fallback keeps them f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kStages = 4;     // depth of the cp.async ring
constexpr int kDepth = 32;     // contracted-axis depth of one stage
constexpr int kPad = 8;        // bf16 of padding per shared-memory row
constexpr int kRowTile = 128;  // gmm's rows per block
constexpr int kSwizzle = 8;    // row (K) tiles per column sweep

// c += a * b for one m16n8k16 tile: bf16 operands, f32 accumulators.
// a: (row g, k 2t..2t+1), (row g+8, k 2t..), (row g, k 2t+8..), (row g+8,
// k 2t+8..); b: (k 2t..2t+1, n g), (k 2t+8.., n g); c: (row g, n 2t, 2t+1),
// (row g+8, n 2t, 2t+1); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const bf16* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 blocks; lanes 8i..8i+7 give the row addresses of block i, and
// register i receives block i: (row lane/4, elements 2(lane%4), +1), or with
// .trans the transposed pair (rows 2(lane%4), +1 of element lane/4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

// Warp layout of a BM x BN output tile: WM x WN warps, each owning TM x TN
// (MT m16 tiles by NT n8 tiles; NT even, B fragments come in pairs).
template <int BM, int BN>
struct Warps {
  static constexpr int WM = (BM == 128 && BN == 64) ? 4 : 2;
  static constexpr int WN = 8 / WM;
  static constexpr int TM = BM / WM;
  static constexpr int TN = BN / WN;
  static constexpr int MT = TM / 16;
  static constexpr int NT = TN / 8;
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp layout");
};

// The product of one staged 32-deep slice into the warp's accumulators.
// A is [BM][LDA] with the contracted axis contiguous (A_TRANS false) or
// [kDepth][LDA] with the output rows contiguous (A_TRANS); B is [kDepth][LDB]
// with the output columns contiguous (B_NK false) or [BN][LDB] with the
// contracted axis contiguous (B_NK).
template <int BM, int BN, bool A_TRANS, bool B_NK, int LDA, int LDB>
__device__ __forceinline__ void stage_product(
    float (&acc)[Warps<BM, BN>::MT][Warps<BM, BN>::NT][4], const bf16* as,
    const bf16* bs, int wm, int wn, int lane) {
  using W = Warps<BM, BN>;
  const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kDepth; kk += 16) {
    uint32_t a[W::MT][4];
#pragma unroll
    for (int mt = 0; mt < W::MT; ++mt) {
      const int m0 = wm * W::TM + mt * 16;
      if (A_TRANS) {
        // Block i: contracted rows kk + 8 (i >= 2), output rows m0 + 8 (i odd).
        ldsm_x4_trans(a[mt], as + (kk + r8 + ((mat >> 1) << 3)) * LDA + m0 +
                                 ((mat & 1) << 3));
      } else {
        // Block i: output rows m0 + 8 (i odd), contracted kk + 8 (i >= 2).
        ldsm_x4(a[mt],
                as + (m0 + r8 + ((mat & 1) << 3)) * LDA + kk + ((mat >> 1) << 3));
      }
    }
#pragma unroll
    for (int j = 0; j < W::NT; j += 2) {
      const int n0 = wn * W::TN + j * 8;
      uint32_t b[4];  // b0, b1 of n-tile j, then of n-tile j + 1
      if (B_NK) {
        ldsm_x4(b, bs + (n0 + r8 + ((mat >> 1) << 3)) * LDB + kk +
                       ((mat & 1) << 3));
      } else {
        ldsm_x4_trans(b, bs + (kk + r8 + ((mat & 1) << 3)) * LDB + n0 +
                             ((mat >> 1) << 3));
      }
#pragma unroll
      for (int mt = 0; mt < W::MT; ++mt) {
        mma(acc[mt][j], a[mt], b[0], b[1]);
        mma(acc[mt][j + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// The cp.async ring over n_steps stages: load(stage, step) fills a stage,
// the product consumes it.
template <int BM, int BN, bool A_TRANS, bool B_NK, int LDA, int LDB,
          int STAGE, int A_ELEMS, typename Load>
__device__ __forceinline__ void pipeline(
    float (&acc)[Warps<BM, BN>::MT][Warps<BM, BN>::NT][4], bf16* smem,
    int n_steps, Load load) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % Warps<BM, BN>::WM, wn = warp / Warps<BM, BN>::WM;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `step` landed; stage step-1's readers are done
    {
      const int next = step + kStages - 1;
      if (next < n_steps) load(next % kStages, next);
      cp_async_commit();
    }
    const bf16* as = smem + (step % kStages) * STAGE;
    stage_product<BM, BN, A_TRANS, B_NK, LDA, LDB>(acc, as, as + A_ELEMS, wm,
                                                   wn, lane);
  }
  cp_async_wait<0>();
}

template <int BN, bool B_NK>
struct GmmCfg {
  static constexpr int BM = kRowTile;
  static constexpr int LDA = kDepth + kPad;
  static constexpr int LDB = B_NK ? kDepth + kPad : BN + kPad;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE = A_ELEMS + (B_NK ? BN : kDepth) * LDB;
  static constexpr int SMEM = kStages * STAGE * 2;
};

template <int BN, bool B_NK>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
           const int32_t* __restrict__ sizes, bf16* __restrict__ out,
           int rows, int kdim, int ndim, int n_groups, int n_items) {
  using C = GmmCfg<BN, B_NK>;
  using W = Warps<C::BM, BN>;
  constexpr int BM = C::BM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  int item, col;
  swizzle(blockIdx.x, n_items, ndim / BN, item, col);
  const int c0 = col * BN;

  // The block's (row tile, group) intersection: rows [lo, hi) of tile
  // `tile`, all in `group`. Every thread walks the same prefix sums.
  int group = -1, tile = 0, lo = 0, hi = 0, start = 0;
  for (int g = 0; g < n_groups; ++g) {
    const int size = max(sizes[g], 0);
    const int s = min(start, rows), e = min(start + size, rows);
    const int n = e > s ? (e - 1) / BM - s / BM + 1 : 0;
    if (item < n) {
      group = g;
      tile = s / BM + item;
      lo = max(s, tile * BM);
      hi = min(e, tile * BM + BM);
      break;
    }
    item -= n;
    start += size;
  }
  if (group < 0) {
    // Past the intersections: item-th tile from the one holding the first
    // row past the last group; its rows past the groups are zeros.
    const int total = min(start, rows);
    tile = total / BM + item;
    lo = max(total, tile * BM);
    hi = min(rows, tile * BM + BM);
    for (int i = threadIdx.x; i < (hi - lo) * (BN / 8); i += kThreads) {
      const int r = lo + i / (BN / 8), c = c0 + (i % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(out + (size_t)r * ndim + c) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const int row0 = tile * BM;
  const bf16* w = rhs + (size_t)group * kdim * ndim;
  auto load = [&](int stage, int step) {
    const int k0 = step * kDepth;
    bf16* as = smem + stage * C::STAGE;
    bf16* bs = as + C::A_ELEMS;
    for (int i = threadIdx.x; i < BM * (kDepth / 8); i += kThreads) {
      const int r = i / (kDepth / 8), c = (i % (kDepth / 8)) * 8;
      const int gr = row0 + r;
      const bool ok = gr >= lo && gr < hi;
      cp_async16(as + r * C::LDA + c,
                 lhs + (size_t)(ok ? gr : lo) * kdim + k0 + c, ok);
    }
    if (B_NK) {
      // Stored [E, N, K]: column n of this group is a contiguous K row.
      for (int i = threadIdx.x; i < BN * (kDepth / 8); i += kThreads) {
        const int n = i / (kDepth / 8), c = (i % (kDepth / 8)) * 8;
        cp_async16(bs + n * C::LDB + c, w + (size_t)(c0 + n) * kdim + k0 + c,
                   true);
      }
    } else {
      for (int i = threadIdx.x; i < kDepth * (BN / 8); i += kThreads) {
        const int kr = i / (BN / 8), c = (i % (BN / 8)) * 8;
        cp_async16(bs + kr * C::LDB + c, w + (size_t)(k0 + kr) * ndim + c0 + c,
                   true);
      }
    }
  };

  float acc[W::MT][W::NT][4];
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  pipeline<BM, BN, false, B_NK, C::LDA, C::LDB, C::STAGE, C::A_ELEMS>(
      acc, smem, kdim / kDepth, load);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % W::WM, wn = warp / W::WM;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < W::MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + wm * W::TM + mt * 16 + g + 8 * hh;
      if (r < lo || r >= hi) continue;
#pragma unroll
      for (int j = 0; j < W::NT; ++j) {
        const int c = c0 + wn * W::TN + j * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * ndim + c) =
            __floats2bfloat162_rn(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
      }
    }
  }
}

template <int BM, int BN>
struct TgmmCfg {
  static constexpr int LDA = BM + kPad;
  static constexpr int LDB = BN + kPad;
  static constexpr int A_ELEMS = kDepth * LDA;
  static constexpr int STAGE = A_ELEMS + kDepth * LDB;
  static constexpr int SMEM = kStages * STAGE * 2;
};

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
tgmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
            const int32_t* __restrict__ sizes, float* __restrict__ out,
            int rows, int kdim, int ndim) {
  using C = TgmmCfg<BM, BN>;
  using W = Warps<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int e = blockIdx.y;
  int kt, nt;
  swizzle(blockIdx.x, kdim / BM, ndim / BN, kt, nt);
  const int k0 = kt * BM, n0 = nt * BN;
  int start = 0;
  for (int g = 0; g < e; ++g) start += max(sizes[g], 0);
  const int lo = min(start, rows), hi = min(start + max(sizes[e], 0), rows);
  const int n_steps = hi > lo ? (hi - lo + kDepth - 1) / kDepth : 0;

  auto load = [&](int stage, int step) {
    const int r0 = lo + step * kDepth;
    bf16* as = smem + stage * C::STAGE;
    bf16* bs = as + C::A_ELEMS;
    for (int i = threadIdx.x; i < kDepth * (BM / 8); i += kThreads) {
      const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
      const bool ok = r0 + r < hi;
      cp_async16(as + r * C::LDA + c,
                 lhs + (size_t)(ok ? r0 + r : lo) * kdim + k0 + c, ok);
    }
    for (int i = threadIdx.x; i < kDepth * (BN / 8); i += kThreads) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = r0 + r < hi;
      cp_async16(bs + r * C::LDB + c,
                 rhs + (size_t)(ok ? r0 + r : lo) * ndim + n0 + c, ok);
    }
  };

  float acc[W::MT][W::NT][4];
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  pipeline<BM, BN, true, false, C::LDA, C::LDB, C::STAGE, C::A_ELEMS>(
      acc, smem, n_steps, load);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % W::WM, wn = warp / W::WM;
  const int g = lane >> 2, t = lane & 3;
  float* o = out + (size_t)e * kdim * ndim;
#pragma unroll
  for (int mt = 0; mt < W::MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = k0 + wm * W::TM + mt * 16 + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < W::NT; ++j) {
        const int c = n0 + wn * W::TN + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(o + (size_t)r * ndim + c) =
            make_float2(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
      }
    }
  }
}

template <int BN, bool B_NK>
int launch_gmm(const void* lhs, const void* rhs, const void* sizes, void* out,
               int rows, int kdim, int ndim, int n_groups, cudaStream_t st) {
  using C = GmmCfg<BN, B_NK>;
  auto kernel = gmm_kernel<BN, B_NK>;
  if (int rc = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM)))
    return rc;
  const long long n_items = (rows + kRowTile - 1) / kRowTile + n_groups;
  const long long blocks = n_items * (ndim / BN);
  if (blocks > 0x7fffffffLL) return -1;
  kernel<<<static_cast<unsigned>(blocks), kThreads, C::SMEM, st>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs),
      static_cast<const int32_t*>(sizes), static_cast<bf16*>(out), rows, kdim,
      ndim, n_groups, static_cast<int>(n_items));
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN>
int launch_tgmm(const void* lhs, const void* rhs, const void* sizes,
                void* out, int rows, int kdim, int ndim, int n_groups,
                cudaStream_t st) {
  using C = TgmmCfg<BM, BN>;
  auto kernel = tgmm_kernel<BM, BN>;
  if (int rc = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM)))
    return rc;
  const long long tiles = (long long)(kdim / BM) * (ndim / BN);
  if (tiles > 0x7fffffffLL) return -1;
  const dim3 grid(static_cast<unsigned>(tiles), n_groups);
  kernel<<<grid, kThreads, C::SMEM, st>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs),
      static_cast<const int32_t*>(sizes), static_cast<float*>(out), rows, kdim,
      ndim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [rows, n] = lhs [rows, k] times rhs [E, k, n] per group; rhs stored
// [E, k, n], or [E, n, k] when rhs_transposed. k in steps of 32, n of 64.
extern "C" int grouped_matmul(const void* lhs, const void* rhs,
                              const void* group_sizes, void* out, int rows,
                              int k, int n, int n_groups, int rhs_transposed,
                              void* stream) {
  if (rows < 0 || k <= 0 || k % kDepth || n <= 0 || n % 64 || n_groups <= 0)
    return -1;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = n % 128 == 0;
  if (rhs_transposed)
    return wide ? launch_gmm<128, true>(lhs, rhs, group_sizes, out, rows, k,
                                        n, n_groups, st)
                : launch_gmm<64, true>(lhs, rhs, group_sizes, out, rows, k, n,
                                       n_groups, st);
  return wide ? launch_gmm<128, false>(lhs, rhs, group_sizes, out, rows, k, n,
                                       n_groups, st)
              : launch_gmm<64, false>(lhs, rhs, group_sizes, out, rows, k, n,
                                      n_groups, st);
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
  if (k % 128 == 0)
    return n % 128 == 0 ? launch_tgmm<128, 128>(lhs, rhs, group_sizes, out,
                                                rows, k, n, n_groups, st)
                        : launch_tgmm<128, 64>(lhs, rhs, group_sizes, out,
                                               rows, k, n, n_groups, st);
  return n % 128 == 0 ? launch_tgmm<64, 128>(lhs, rhs, group_sizes, out, rows,
                                             k, n, n_groups, st)
                      : launch_tgmm<64, 64>(lhs, rhs, group_sizes, out, rows,
                                            k, n, n_groups, st);
}
