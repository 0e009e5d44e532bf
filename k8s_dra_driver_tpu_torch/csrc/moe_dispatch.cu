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
//                     interleave on the axis of size 2, M contiguous),
//                     row_ids [r_pad] int32 (sentinel T: a zero row)
//                     -> act [r_pad, M] bf16 = silu(g) * u, g and u in f32
//   moe_down_combine: act [r_pad, M] bf16, w_down [E, M, H] bf16,
//                     gates [r_pad] f32, pair_ids [r_pad] int32 (sentinel
//                     n_pairs: not written) -> out [n_pairs, H] f32, which
//                     the caller zero-fills; each live row writes
//                     (act_row . W_down[e]) * gate to its own pair slot, so
//                     no two rows share a slot and no atomics are needed.
//
// What bounds them on the H100. At decode (8 tokens, 16 pairs, tile 8)
// every touched expert's weights are read once for a handful of rows:
// 2 operations per weight byte, bound by bytes (up to 1.88 GB for the
// gate/up stack and 0.94 GB for the down stack of one Mixtral-8x7B layer,
// 0.84 ms at 3.35 TB/s). At a 512-token prefill chunk (tile 128, ~128 rows
// per expert) each weight byte feeds ~128 rows: bound by operations (0.24
// ms per product at 989 TFLOP/s) once the tensor cores do them.
//
// Design. One block owns one row tile and a block of output columns, and
// walks the contracted axis itself in steps of 32 (the Pallas grid's inner
// axis). Its 8 warps split the tile's rows in slabs of 16 (a tile of 8 is
// padded to 16 with zero rows, as mma needs) and the columns among the rest.
// Each product is a warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate);
// wgmma and TMA are later steps. Stages are filled by cp.async in a ring
// (3 deep, 6 at tile 16 where only the weight stream matters), the tile's
// rows gathered straight from the unsorted token buffer (cp.async with a
// zero source size fills sentinel and padding rows with zeros): the sorted
// [r_pad, H] buffer never exists. The weights stay as stored, the
// contracted axis strided, and ldmatrix.trans turns each 8x8 block into
// the B fragment while reading it from shared memory. moe_gateup stages
// both halves of its 64 columns (gate and up) side by side, so each thread
// holds g and u of the same elements and applies SwiGLU in registers.
// moe_down_combine multiplies by the row's gate and writes each row to its
// pair slot. A tile whose rows are all sentinels reads no weights:
// moe_gateup writes its zeros and moe_down_combine returns at once.
//
// The int8 branches (INT8) take the expert stacks as int8 with per-column
// f32 scales (w_gu [E, H, 2, M] with scale [E, 1, 2, M]; w_down [E, M, H]
// with scale [E, 1, H]). At decode they are bound by the same weight bytes
// at one byte a weight: half the bf16 bound. The ring stages the weight
// tile as int8 (16 weights per 16-byte cp.async, half the bf16 stage);
// after each stage lands, the block converts it exactly to bf16 into one
// shared image in the B layout above, and a barrier later the same
// ldmatrix.trans and bf16 mma.sync read it. The scales are constant over
// the contracted axis, so they multiply the f32 sums in the epilogue:
// moe_gateup scales g and u by the tile expert's gate- and up-half scale
// of each column before SwiGLU, moe_down_combine scales each column before
// the row's gate. All-sentinel tiles read neither weights nor scales.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = 8;
constexpr int kBK = 32;        // contracted-axis depth of one stage
constexpr int kPad = 8;        // bf16 of padding per shared-memory row
constexpr int kCols = 64;      // output columns of one block

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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
// (n contiguous). ldmatrix.trans reads two 8x8 blocks, rows k0.. and
// k0+8.. (addresses from lanes 0-7 and 8-15), and hands each thread the
// transposed pairs (k 2t, 2t+1 at n g) the mma wants.
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

// Exact int8 -> bf16 of the two bytes of w at bit sh and sh + 8, packed
// as one bf16 pair (the lower address in the low half).
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(int32_t w, int sh) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(
      static_cast<float>(static_cast<int8_t>(w >> sh)),
      static_cast<float>(static_cast<int8_t>(w >> (sh + 8))));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The weights of a branch: bf16, or int8.
template <bool INT8>
using Weight = std::conditional_t<INT8, int8_t, bf16>;

// BM: rows of the block (>= the plan's tile); GATEUP: moe_gateup, else
// moe_down_combine; INT8: int8 weights (staged as int8, converted into one
// bf16 image per stage).
template <int BM, bool GATEUP, bool INT8>
struct Cfg {
  static constexpr int NB = GATEUP ? 2 * kCols : kCols;  // staged columns
  static constexpr int WM = BM / 16;                      // warps on rows
  static constexpr int WN = kWarps / WM;                  // warps on columns
  static constexpr int WCOLS = kCols / WN;  // output columns of one warp
  static constexpr int NT = WCOLS / 8;      // its n-tiles (per half)
  static constexpr int NACC = GATEUP ? 2 * NT : NT;
  static constexpr int STAGES = BM <= 16 ? 6 : 3;
  static constexpr int LDA = kBK + kPad;
  static constexpr int LDB = NB + kPad;
  // A stage in bf16 elements: the row tile, then the weight tile, bf16
  // [kBK][LDB] or int8 [kBK][NB] (half as many elements). Addresses stay
  // in bf16 elements: byte-based stage arithmetic made the bf16 K8 at
  // decode 15% slower on the H100.
  static constexpr int B_STAGE = INT8 ? kBK * NB / 2 : kBK * LDB;
  static constexpr int STAGE = BM * LDA + B_STAGE;
  static constexpr int IMAGE = INT8 ? kBK * LDB : 0;  // the int8 tile as bf16
  static constexpr int SMEM = (STAGES * STAGE + IMAGE) * 2 + 2 * BM * 4;
  static_assert(WM * WN == kWarps && NT >= 1, "warp layout");
  static_assert(BM * LDA % 8 == 0 && B_STAGE % 8 == 0, "16-byte stages");
};

template <int BM, bool GATEUP, bool INT8>
__global__ void __launch_bounds__(kThreads)
moe_grouped_kernel(const bf16* __restrict__ a_src,   // xf, or act
                   const Weight<INT8>* __restrict__ w,  // w_gu, or w_down
                   const float* __restrict__ wscale, // INT8 scales
                   const int32_t* __restrict__ ids,  // row_ids, or pair_ids
                   const int32_t* __restrict__ tile_expert,
                   const float* __restrict__ gates,  // moe_down_combine
                   void* __restrict__ out,           // act, or y_pairs
                   int kdim,    // contracted: H, or M
                   int ndim,    // output width: M, or H
                   int tile, int limit) {
  using C = Cfg<BM, GATEUP, INT8>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  bf16* image = stages + C::STAGES * C::STAGE;
  int* a_row =
      reinterpret_cast<int*>(smem + (C::STAGES * C::STAGE + C::IMAGE) * 2);
  int* dst_row = a_row + BM;

  const int r0 = blockIdx.x * tile;   // the tile's first slot
  const int c0 = blockIdx.y * kCols;  // the block's first output column
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int g = lane >> 2, t = lane & 3;

  // Per row of the block: where its A row comes from and where its output
  // goes (-1: zeros in, nothing out). BM <= kThreads, one row a thread.
  int live = 0;
  if (threadIdx.x < BM) {
    const int r = threadIdx.x;
    int src = -1, dst = -1;
    if (r < tile) {
      const int id = ids[r0 + r];
      const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(limit);
      live = ok;
      if (GATEUP) {
        src = ok ? id : -1;  // gather from the token buffer
        dst = r0 + r;        // every slot of the tile is written
      } else {
        src = ok ? r0 + r : -1;
        dst = ok ? id : -1;  // scatter to the pair slot
      }
    }
    a_row[r] = src;
    dst_row[r] = dst;
  }
  if (!__syncthreads_or(live)) {
    // All sentinels: the output is zero, and no weight is read.
    if (GATEUP) {
      bf16* act = static_cast<bf16*>(out);
      for (int i = threadIdx.x; i < tile * (kCols / 8); i += kThreads) {
        const int r = i / (kCols / 8), c = (i % (kCols / 8)) * 8;
        *reinterpret_cast<uint4*>(act + (size_t)(r0 + r) * ndim + c0 + c) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  const int e = tile_expert[blockIdx.x];
  const Weight<INT8>* wexp =
      w + (size_t)e * kdim * (GATEUP ? 2 * ndim : ndim);

  // Weight (contracted row k, staged column c) of the tile's expert; staged
  // row k of moe_gateup is [gate c0..c0+63 | up c0..c0+63] of row k.
  auto w_at = [&](int k, int c) -> const Weight<INT8>* {
    if (GATEUP) {
      const int half = c >= kCols;
      return wexp + ((size_t)k * 2 + half) * ndim + c0 + c - half * kCols;
    }
    return wexp + (size_t)k * ndim + c0 + c;
  };

  auto load_stage = [&](int stage, int k0) {
    bf16* as = stages + stage * C::STAGE;
    bf16* bs = as + BM * C::LDA;
    for (int i = threadIdx.x; i < BM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const int src = a_row[r];
      cp_async16(as + r * C::LDA + c,
                 a_src + (size_t)(src < 0 ? 0 : src) * kdim + k0 + c,
                 src >= 0);
    }
    if constexpr (INT8) {
      int8_t* b8 = reinterpret_cast<int8_t*>(bs);
      for (int i = threadIdx.x; i < kBK * (C::NB / 16); i += kThreads) {
        const int kr = i / (C::NB / 16), c = (i % (C::NB / 16)) * 16;
        cp_async16(b8 + kr * C::NB + c, w_at(k0 + kr, c), true);
      }
    } else {
      for (int i = threadIdx.x; i < kBK * (C::NB / 8); i += kThreads) {
        const int kr = i / (C::NB / 8), c = (i % (C::NB / 8)) * 8;
        cp_async16(bs + kr * C::LDB + c, w_at(k0 + kr, c), true);
      }
    }
  };

  // INT8: the landed int8 weight tile of a stage -> the bf16 image, 16
  // weights a thread.
  auto convert_stage = [&](int stage) {
    const int8_t* b8 = reinterpret_cast<const int8_t*>(
        stages + stage * C::STAGE + BM * C::LDA);
    for (int i = threadIdx.x; i < kBK * (C::NB / 16); i += kThreads) {
      const int kr = i / (C::NB / 16), c = (i % (C::NB / 16)) * 16;
      const int4 raw = *reinterpret_cast<const int4*>(b8 + kr * C::NB + c);
      uint4* dst = reinterpret_cast<uint4*>(image + kr * C::LDB + c);
      dst[0] = make_uint4(int8x2_to_bf16x2(raw.x, 0),
                          int8x2_to_bf16x2(raw.x, 16),
                          int8x2_to_bf16x2(raw.y, 0),
                          int8x2_to_bf16x2(raw.y, 16));
      dst[1] = make_uint4(int8x2_to_bf16x2(raw.z, 0),
                          int8x2_to_bf16x2(raw.z, 16),
                          int8x2_to_bf16x2(raw.w, 0),
                          int8x2_to_bf16x2(raw.w, 16));
    }
  };

  float acc[C::NACC][4];
#pragma unroll
  for (int j = 0; j < C::NACC; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  const int kt_n = kdim / kBK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < kt_n) load_stage(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt-1's readers are done
    {
      const int nk = kt + C::STAGES - 1;
      if (nk < kt_n) load_stage(nk % C::STAGES, nk * kBK);
      cp_async_commit();
    }
    const bf16* as = stages + (kt % C::STAGES) * C::STAGE;
    const bf16* bs = as + BM * C::LDA;
    if constexpr (INT8) {
      // The image's previous readers passed the barrier above.
      convert_stage(kt % C::STAGES);
      __syncthreads();
      bs = image;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4];
      load_a(a, as, C::LDA, wm * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < C::NACC; ++j) {
        // Gate n-tiles first, then the up n-tiles of the same columns.
        const int n0 = (j >= C::NT ? kCols : 0) + wn * C::WCOLS +
                       8 * (j % C::NT);
        uint32_t b0, b1;
        load_b_trans(b0, b1, bs, C::LDB, kk, n0, lane);
        mma(acc[j], a, b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < C::NT; ++j) {
    const int col = c0 + wn * C::WCOLS + 8 * j + 2 * t;
    // INT8: the columns' scales, [E, 1, 2, M] (gate half, then up half)
    // for moe_gateup, [E, 1, H] for moe_down_combine.
    float sg0 = 1.f, sg1 = 1.f, su0 = 1.f, su1 = 1.f;
    if constexpr (INT8) {
      const float* sc = wscale + (size_t)e * (GATEUP ? 2 * ndim : ndim);
      sg0 = sc[col];
      sg1 = sc[col + 1];
      if (GATEUP) {
        su0 = sc[ndim + col];
        su1 = sc[ndim + col + 1];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 16 + g + 8 * hh;
      const int dst = dst_row[r];
      if (dst < 0) continue;
      float v0 = acc[j][2 * hh], v1 = acc[j][2 * hh + 1];
      if constexpr (INT8) {
        v0 *= sg0;
        v1 *= sg1;
      }
      if (GATEUP) {
        // acc[j + NT] holds the up half of the same elements.
        float u0 = acc[j + (GATEUP ? C::NT : 0)][2 * hh];
        float u1 = acc[j + (GATEUP ? C::NT : 0)][2 * hh + 1];
        if constexpr (INT8) {
          u0 *= su0;
          u1 *= su1;
        }
        const float s0 = v0 / (1.f + expf(-v0)) * u0;
        const float s1 = v1 / (1.f + expf(-v1)) * u1;
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                           (size_t)dst * ndim + col) =
            __floats2bfloat162_rn(s0, s1);
      } else {
        const float gt = gates[r0 + r];
        *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                   (size_t)dst * ndim + col) =
            make_float2(v0 * gt, v1 * gt);
      }
    }
  }
}

template <int BM, bool GATEUP, bool INT8>
int launch(const void* a_src, const void* w, const void* wscale,
           const void* ids, const void* tile_expert, const void* gates,
           void* out, int kdim, int ndim, int r_pad, int tile, int limit,
           cudaStream_t st) {
  using C = Cfg<BM, GATEUP, INT8>;
  auto kernel = moe_grouped_kernel<BM, GATEUP, INT8>;
  // The ring can pass the 48 KB static limit: raise the kernel's limit.
  if (int rc = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM)))
    return rc;
  const dim3 grid(r_pad / tile, ndim / kCols);
  kernel<<<grid, kThreads, C::SMEM, st>>>(
      static_cast<const bf16*>(a_src),
      static_cast<const Weight<INT8>*>(w),
      static_cast<const float*>(wscale),
      static_cast<const int32_t*>(ids),
      static_cast<const int32_t*>(tile_expert),
      static_cast<const float*>(gates), out, kdim, ndim, tile, limit);
  return static_cast<int>(cudaGetLastError());
}

template <bool GATEUP, bool INT8>
int dispatch(const void* a_src, const void* w, const void* wscale,
             const void* ids, const void* tile_expert, const void* gates,
             void* out, int kdim, int ndim, int r_pad, int tile, int limit,
             void* stream) {
  if (tile <= 0 || tile % 8 || tile > 128 || r_pad <= 0 || r_pad % tile ||
      kdim <= 0 || kdim % kBK || ndim <= 0 || ndim % kCols || limit < 0 ||
      ndim / kCols > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile <= 16)
    return launch<16, GATEUP, INT8>(a_src, w, wscale, ids, tile_expert,
                                    gates, out, kdim, ndim, r_pad, tile,
                                    limit, st);
  if (tile <= 64)
    return launch<64, GATEUP, INT8>(a_src, w, wscale, ids, tile_expert,
                                    gates, out, kdim, ndim, r_pad, tile,
                                    limit, st);
  return launch<128, GATEUP, INT8>(a_src, w, wscale, ids, tile_expert, gates,
                                   out, kdim, ndim, r_pad, tile, limit, st);
}

}  // namespace

extern "C" int moe_gateup(const void* xf, const void* w_gu,
                          const void* row_ids, const void* tile_expert,
                          void* act, int n_tokens, int h, int m, int r_pad,
                          int tile, void* stream) {
  return dispatch<true, false>(xf, w_gu, nullptr, row_ids, tile_expert,
                               nullptr, act, h, m, r_pad, tile, n_tokens,
                               stream);
}

extern "C" int moe_down_combine(const void* act, const void* w_down,
                                const void* gates, const void* pair_ids,
                                const void* tile_expert, void* out,
                                int n_pairs, int m, int h, int r_pad,
                                int tile, void* stream) {
  return dispatch<false, false>(act, w_down, nullptr, pair_ids, tile_expert,
                                gates, out, m, h, r_pad, tile, n_pairs,
                                stream);
}

extern "C" int moe_gateup_int8(const void* xf, const void* w_gu,
                               const void* scale, const void* row_ids,
                               const void* tile_expert, void* act,
                               int n_tokens, int h, int m, int r_pad,
                               int tile, void* stream) {
  return dispatch<true, true>(xf, w_gu, scale, row_ids, tile_expert, nullptr,
                              act, h, m, r_pad, tile, n_tokens, stream);
}

extern "C" int moe_down_combine_int8(const void* act, const void* w_down,
                                     const void* scale, const void* gates,
                                     const void* pair_ids,
                                     const void* tile_expert, void* out,
                                     int n_pairs, int m, int h, int r_pad,
                                     int tile, void* stream) {
  return dispatch<false, true>(act, w_down, scale, pair_ids, tile_expert,
                               gates, out, m, h, r_pad, tile, n_pairs,
                               stream);
}
