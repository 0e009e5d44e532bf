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
// M <= 64 (decode): one block of 8 warps owns BM rows (16 or 64; M padded
// up by zero-filled rows) and 64 output columns, and walks its slice of K
// in steps of 64 through a cp.async ring (6 stages at BM 16 where only the
// weight stream matters, 3 at BM 64). The weight tile is staged as int8
// (16 weights per 16-byte cp.async), converted once per stage into one
// bf16 image in shared memory (exactly, or times the column's scale in the
// prologue mode; each converting thread keeps its 16 columns' scales in
// registers), and a barrier later ldmatrix.trans and mma.sync.m16n8k16
// read it. N/64 blocks do not fill 132 SMs (wo: 64 blocks), so the wrapper
// may split K 2 or 4 ways.
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
#include "int8_image.cuh"  // cvt8, convert_rows: int8 tiles into bf16 images

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = 8;
constexpr int kBK = 64;        // K depth of one stage
constexpr int kCols = 64;      // output columns of one block
constexpr int kPad = 8;        // bf16 of padding per shared-memory row

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment: rows [r0, r0 + 16) x k [k0, k0 + 16) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int r0, int k0, int g, int t) {
  const bf16* p = s + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment: k [k0, k0 + 16) x n [n0, n0 + 8) of a tile stored [k][n]
// (n contiguous), transposed by ldmatrix.trans.
__device__ __forceinline__ void load_b_trans(uint32_t& b0, uint32_t& b1,
                                             const bf16* s, int ld, int k0,
                                             int n0, int lane) {
  const bf16* p = s + (k0 + (lane & 15)) * ld + n0;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
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

// Two int8 of w (bits sh and sh + 8) as a bf16 pair: exact, or times
// their columns' scales s0, s1 in f32 and then rounded (PROLOGUE).
template <bool PROLOGUE>
__device__ __forceinline__ uint32_t cvt2(int32_t w, int sh, float s0,
                                         float s1) {
  float a = static_cast<float>(static_cast<int8_t>(w >> sh));
  float b = static_cast<float>(static_cast<int8_t>(w >> (sh + 8)));
  if (PROLOGUE) {
    a *= s0;
    b *= s1;
  }
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int BM>
struct Cfg {
  static constexpr int WM = BM / 16;        // warps on rows
  static constexpr int WN = kWarps / WM;    // warps on columns
  static constexpr int WCOLS = kCols / WN;  // output columns of one warp
  static constexpr int NT = WCOLS / 8;      // its n-tiles
  static constexpr int STAGES = BM <= 16 ? 6 : 3;
  static constexpr int LDA = kBK + kPad;
  static constexpr int LDB = kCols + kPad;
  // A stage in bf16 elements: the row tile, then the int8 weight tile
  // [kBK][kCols] (half as many bf16 elements).
  static constexpr int B_STAGE = kBK * kCols / 2;
  static constexpr int STAGE = BM * LDA + B_STAGE;
  static constexpr int IMAGE = kBK * LDB;   // the weight tile as bf16
  static constexpr int SMEM = (STAGES * STAGE + IMAGE) * 2;
  static_assert(WM * WN == kWarps && NT >= 1, "warp layout");
  static_assert(BM * LDA % 8 == 0 && B_STAGE % 8 == 0, "16-byte stages");
  // Each converting thread keeps one fixed group of 16 columns.
  static_assert(kThreads % (kCols / 16) == 0, "fixed conversion columns");
};

// SPLIT: write f32 partial sums to part[s, e, m, n] (the reduce pass
// finishes them); else apply the epilogue and write y.
template <int BM, bool PROLOGUE, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, bf16* __restrict__ y,
                   float* __restrict__ part, int m, int n, int k,
                   int split) {
  using C = Cfg<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  bf16* image = stages + C::STAGES * C::STAGE;

  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * BM;
  const int e = blockIdx.z / split, s = blockIdx.z % split;
  const int e_count = gridDim.z / split;
  const int k_len = k / split, k_base = s * k_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int g = lane >> 2, t = lane & 3;

  const bf16* xe = x + (size_t)e * m * k;
  const int8_t* qe = q + (size_t)e * k * n;
  const float* se = scale + (size_t)e * n;

  // The 16 columns this thread converts, and (PROLOGUE) their scales.
  const int cv_col = (threadIdx.x % (kCols / 16)) * 16;
  float cs[16];
#pragma unroll
  for (int u = 0; u < 16; ++u)
    cs[u] = (PROLOGUE && n0 + cv_col + u < n) ? se[n0 + cv_col + u] : 0.f;

  auto load_stage = [&](int stage, int k0) {
    bf16* as = stages + stage * C::STAGE;
    int8_t* b8 = reinterpret_cast<int8_t*>(as + BM * C::LDA);
    for (int i = threadIdx.x; i < BM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool ok = m0 + r < m;
      cp_async16(as + r * C::LDA + c,
                 xe + (size_t)(ok ? m0 + r : 0) * k + k0 + c, ok);
    }
    for (int i = threadIdx.x; i < kBK * (kCols / 16); i += kThreads) {
      const int kr = i / (kCols / 16), c = (i % (kCols / 16)) * 16;
      const bool ok = n0 + c < n;
      cp_async16(b8 + kr * kCols + c,
                 qe + (size_t)(k0 + kr) * n + (ok ? n0 + c : 0), ok);
    }
  };

  // The landed int8 weight tile of a stage -> the bf16 image.
  auto convert_stage = [&](int stage) {
    const int8_t* b8 = reinterpret_cast<const int8_t*>(
        stages + stage * C::STAGE + BM * C::LDA);
    for (int i = threadIdx.x; i < kBK * (kCols / 16); i += kThreads) {
      const int kr = i / (kCols / 16);
      const int4 raw =
          *reinterpret_cast<const int4*>(b8 + kr * kCols + cv_col);
      uint4* dst = reinterpret_cast<uint4*>(image + kr * C::LDB + cv_col);
      dst[0] = make_uint4(cvt2<PROLOGUE>(raw.x, 0, cs[0], cs[1]),
                          cvt2<PROLOGUE>(raw.x, 16, cs[2], cs[3]),
                          cvt2<PROLOGUE>(raw.y, 0, cs[4], cs[5]),
                          cvt2<PROLOGUE>(raw.y, 16, cs[6], cs[7]));
      dst[1] = make_uint4(cvt2<PROLOGUE>(raw.z, 0, cs[8], cs[9]),
                          cvt2<PROLOGUE>(raw.z, 16, cs[10], cs[11]),
                          cvt2<PROLOGUE>(raw.w, 0, cs[12], cs[13]),
                          cvt2<PROLOGUE>(raw.w, 16, cs[14], cs[15]));
    }
  };

  float acc[C::NT][4];
#pragma unroll
  for (int j = 0; j < C::NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  const int kt_n = k_len / kBK;
#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < kt_n) load_stage(st, k_base + st * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt-1's readers are done
    {
      const int nk = kt + C::STAGES - 1;
      if (nk < kt_n) load_stage(nk % C::STAGES, k_base + nk * kBK);
      cp_async_commit();
    }
    const bf16* as = stages + (kt % C::STAGES) * C::STAGE;
    // The image's previous readers passed the barrier above.
    convert_stage(kt % C::STAGES);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4];
      load_a(a, as, C::LDA, wm * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        uint32_t b0, b1;
        load_b_trans(b0, b1, image, C::LDB, kk, wn * C::WCOLS + 8 * j, lane);
        mma(acc[j], a, b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < C::NT; ++j) {
    const int col = n0 + wn * C::WCOLS + 8 * j + 2 * t;
    if (col >= n) continue;  // n % 16 == 0: col < n means col + 1 < n too
    float s0 = 1.f, s1 = 1.f;
    if (!PROLOGUE && !SPLIT) {
      s0 = se[col];
      s1 = se[col + 1];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * 16 + g + 8 * hh;
      if (row >= m) continue;
      const float v0 = acc[j][2 * hh], v1 = acc[j][2 * hh + 1];
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

// The split-K epilogue: y[e, m, n] = bf16(sum over s of part[s, e, m, n],
// times scale[e, n] unless PROLOGUE), the splits summed in order.
template <bool PROLOGUE>
__global__ void __launch_bounds__(256)
int8_matmul_reduce(const float* __restrict__ part,
                   const float* __restrict__ scale, bf16* __restrict__ y,
                   int m, int n, int e_count, int split) {
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
// kernel's launch first).
template <bool PROLOGUE>
int reduce(void* part, const void* scale, void* y, int e, int m, int n,
           int split, cudaStream_t st) {
  if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  const size_t pairs = (size_t)e * m * n / 2;
  int8_matmul_reduce<PROLOGUE>
      <<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<bf16*>(y), m, n, e, split);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, bool PROLOGUE>
int launch(const void* x, const void* q, const void* scale, void* y,
           void* part, int e, int m, int n, int k, int split,
           cudaStream_t st) {
  using C = Cfg<BM>;
  const dim3 grid((n + kCols - 1) / kCols, (m + BM - 1) / BM, e * split);
  if (split > 1) {
    auto kernel = int8_matmul_kernel<BM, PROLOGUE, true>;
    if (int rc = static_cast<int>(cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM)))
      return rc;
    kernel<<<grid, kThreads, C::SMEM, st>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<bf16*>(y),
        static_cast<float*>(part), m, n, k, split);
    return reduce<PROLOGUE>(part, scale, y, e, m, n, split, st);
  } else {
    auto kernel = int8_matmul_kernel<BM, PROLOGUE, false>;
    if (int rc = static_cast<int>(cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM)))
      return rc;
    kernel<<<grid, kThreads, C::SMEM, st>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<bf16*>(y), nullptr, m,
        n, k, 1);
  }
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
                cudaStream_t st) {
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
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n),
                                   static_cast<cuuint64_t>(k) * n};
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
             void* part, int e, int m, int n, int k, int split,
             cudaStream_t st) {
  if (m <= 16) return launch<16, PROLOGUE>(x, q, scale, y, part, e, m, n, k,
                                           split, st);
  if (m <= 64) return launch<64, PROLOGUE>(x, q, scale, y, part, e, m, n, k,
                                           split, st);
  return launch_wide<PROLOGUE>(x, q, scale, y, part, e, m, n, k, split, st);
}

}  // namespace

// x bf16 [e, m, k], q int8 [e, k, n], scale f32 [e, n] -> y bf16 [e, m, n];
// part: f32 scratch [split, e, m, n] when split > 1 (else unused).
// prologue: 0 scales the f32 sum (SCALE_EPILOGUE), 1 stages bf16(q * scale)
// (SCALE_PROLOGUE). Returns -1 for shapes the kernel does not take.
extern "C" int int8_matmul(const void* x, const void* q, const void* scale,
                           void* y, void* part, int e, int m, int n, int k,
                           int split, int prologue, void* stream) {
  if (e <= 0 || m <= 0 || n <= 0 || n % 16 || k <= 0 ||
      (split != 1 && split != 2 && split != 4) || k % (kBK * split) ||
      (split > 1 && part == nullptr) || e * split > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return prologue
             ? dispatch<true>(x, q, scale, y, part, e, m, n, k, split, st)
             : dispatch<false>(x, q, scale, y, part, e, m, n, k, split, st);
}
