// Flash attention for Hopper (sm_90a): the forward kernel and the two
// backward kernels of the dense training path.
//
// Replaces:
//   flash_fwd      <- k8s_dra_driver_tpu/ops/attention.py::_flash_kernel
//   flash_bwd_dkdv <- k8s_dra_driver_tpu/ops/attention.py::_flash_bwd_dkdv_kernel
//   flash_bwd_dq   <- k8s_dra_driver_tpu/ops/attention.py::_flash_bwd_dq_kernel
//
// Layouts are the JAX package's:
//   q, dout, out, dq  [B, Hq, S, D] bf16
//   k, v, dk, dv      [B, H_kv, S, D] bf16; query head h reads kv head h / G
//                     (G = Hq / H_kv)
//   lse, delta        [B, Hq, S] f32; lse is the natural-log logsumexp of each
//                     scaled score row, delta = rowsum(dout * out)
// Query and kv sequences have the same length S (any S: the ragged last tile
// is masked here). With `causal`, query i sees kv positions <= i.
//
// What bounds them on the H100. At the training shape (B 8, Hq 32, H_kv 8,
// S 2048, D 128, causal) the forward does 4 * B * Hq * D * S(S+1)/2 = 2.75e11
// operations on 0.34 GB of inputs and outputs, ~800 operations per byte:
// bound by operations (0.28 ms at 989 TFLOP/s). dK/dV does twice the
// forward's operations and dQ 1.5 times, on a little more bytes. So the
// products must run on the tensor cores: every one of them here is a
// warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate). wgmma, TMA and
// warp specialisation, which the card needs for its full rate, are later
// steps; so is overlapping the next tile's loads with this tile's products.
//
// Design. A block of 4 warps owns one 64-row tile and loops over the tiles of
// the other axis itself: that loop takes the place of the Pallas grid's
// sequential innermost axis, and the accumulators it carries stay in f32
// registers. Each warp owns 16 rows of the block's tile. Score tiles never
// leave registers: the accumulator layout of S (or S^T) for two neighbouring
// 8-column n-tiles is the A-operand layout of the next product's 16-deep
// k-step, so p and dS are packed to bf16 in place (FlashAttention-2's
// register reuse) -- the bf16 rounding the Pallas kernels apply to p and dS
// before their products. B operands are read from shared memory as 32-bit
// pairs, so each operand is staged with its contracted axis contiguous: K,
// V, Q and dO as stored, and V (forward), K (dQ), Q and dO (dK/dV) also
// transposed while staging. Rows are padded by 8 bf16, so the 8 rows x 4
// pairs of one fragment load fall in 32 different banks.
//   flash_fwd:      one block per (q tile of 64, q head, batch); kv tiles of
//                   64 up to the diagonal, online softmax in base 2 (LOG2E
//                   folded into the scale); out = acc / l,
//                   lse = (m + log2 l) / LOG2E.
//   flash_bwd_dkdv: one block per (kv tile of 64, kv head, batch); it computes
//                   S^T = K Q^T and dP^T = V dO^T, and loops over the G query
//                   heads of its group and the q tiles of 32 from the diagonal
//                   on, so dK and dV sum over the group inside the block (no
//                   atomics, no sum over heads afterwards).
//   flash_bwd_dq:   one block per (q tile of 64, q head, batch); kv tiles of 64
//                   up to the diagonal.
// The backward rebuilds p = exp2(s * scale * LOG2E - lse * LOG2E) and masks
// BEFORE the exp2: a masked score can exceed lse, and its exp2 would be inf.
// Tiles wholly below the diagonal run unmasked; only the tiles on the
// diagonal and the ragged last tile pay for the mask. Causal grids start with
// the tiles that have the most work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // 4 warps, 16 rows of the block's tile each
constexpr int kRows = 64;      // rows of the block's own tile
constexpr int kPad = 8;        // bf16 of padding per shared-memory row

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one m16n8k16 tile: bf16 operands, f32 accumulators.
// a: (row g, k 2t..2t+1), (row g+8, k 2t..), (row g, k 2t+8..), (row g+8,
// k 2t+8..); b: (k 2t..2t+1, n g), (k 2t+8.., n g); c: (row g, n 2t, 2t+1),
// (row g+8, n 2t, 2t+1); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
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

// B fragment: n [n0, n0 + 8) x k [k0, k0 + 16) of a tile stored [n][k].
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int ld, int n0, int k0,
                                       int g, int t) {
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// Rows [row0, row0 + ROWS) of a row-major [S, D] matrix into a [ROWS][D + 8]
// tile; rows at or past `limit` become zeros.
template <int D, int ROWS>
__device__ __forceinline__ void stage(bf16* __restrict__ dst,
                                      const bf16* __restrict__ src, int row0,
                                      int limit) {
  constexpr int VEC = D / 8;
  for (int w = threadIdx.x; w < ROWS * VEC; w += kThreads) {
    const int r = w / VEC, c = (w % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = val;
  }
}

// The same rows transposed into a [D][ROWS + 8] tile.
template <int D, int ROWS>
__device__ __forceinline__ void stage_t(bf16* __restrict__ dst,
                                        const bf16* __restrict__ src,
                                        int row0, int limit) {
  constexpr int VEC = D / 8;
  for (int w = threadIdx.x; w < ROWS * VEC; w += kThreads) {
    const int r = w / VEC, c = (w % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    const uint32_t words[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 two = *reinterpret_cast<const __nv_bfloat162*>(&words[i]);
      dst[(c + 2 * i) * (ROWS + kPad) + r] = two.x;
      dst[(c + 2 * i + 1) * (ROWS + kPad) + r] = two.y;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
struct Smem {
  static constexpr int ROW = D + kPad;                  // [rows][D + 8]
  static constexpr int T64 = kRows + kPad;              // [D][64 + 8]
  static constexpr int T32 = 32 + kPad;                 // [D][32 + 8]
  static constexpr int fwd = (2 * kRows * ROW + D * T64) * 2;
  static constexpr int dq = (4 * kRows * ROW + D * T64) * 2;
  static constexpr int dkdv =
      (2 * kRows * ROW + 2 * 32 * ROW + 2 * D * T32) * 2 + 2 * 32 * 4;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int hq, int hkv, int s_len,
                 float scale_log2) {
  constexpr int ROW = Smem<D>::ROW, T64 = Smem<D>::T64, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kRows * ROW;
  bf16* vt_s = k_s + kRows * ROW;  // V^T [D][64 + 8]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kRows;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const size_t qbase = ((size_t)b * hq + h) * s_len;
  const size_t kbase = ((size_t)b * hkv + hk) * s_len;

  stage<D, kRows>(q_s, q + qbase * D, q0, s_len);
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    load_a(qa[kk], q_s, ROW, warp * 16, kk * 16, g, t);

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  const int kv_end = CAUSAL ? min(s_len, q0 + kRows) : s_len;
  for (int k0 = 0; k0 < kv_end; k0 += kRows) {
    __syncthreads();  // the previous tile's readers are done
    stage<D, kRows>(k_s, k + kbase * D, k0, s_len);
    stage_t<D, kRows>(vt_s, v + kbase * D, k0, s_len);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, ROW, nt * 8, kk * 16, g, t);
        mma(s[nt], qa[kk], b0, b1);
      }
    }
    const bool masked =
        (CAUSAL && k0 + kRows - 1 > q0) || k0 + kRows > s_len;
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        float x = s[nt][e] * scale_log2;
        if (masked && (col >= s_len || (CAUSAL && col > row))) x = kNegInf;
        s[nt][e] = x;
        if (e < 2)
          mx_lo = fmaxf(mx_lo, x);
        else
          mx_hi = fmaxf(mx_hi, x);
      }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float c_lo = exp2f(m_lo - mx_lo), c_hi = exp2f(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;

    // p in place as the A operand of P @ V (k = kv position).
    uint32_t pa[4][4];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - mx_lo), p1 = exp2f(s[nt][1] - mx_lo);
      const float p2 = exp2f(s[nt][2] - mx_hi), p3 = exp2f(s[nt][3] - mx_hi);
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      pa[nt / 2][(nt % 2) * 2] = pack(p0, p1);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack(p2, p3);
    }
    l_lo = l_lo * c_lo + sum_lo;  // this thread's columns; summed at the end
    l_hi = l_hi * c_hi + sum_hi;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= c_lo;
      o[dn][1] *= c_lo;
      o[dn][2] *= c_hi;
      o[dn][3] *= c_hi;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        load_b(b0, b1, vt_s, T64, dn * 8, kk * 16, g, t);
        mma(o[dn], pa[kk], b0, b1);
      }
    }
  }

  const float li_lo = fmaxf(quad_sum(l_lo), 1e-30f);
  const float li_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  const float inv_lo = 1.f / li_lo, inv_hi = 1.f / li_hi;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row_lo < s_len)
      *reinterpret_cast<__nv_bfloat162*>(out + (qbase + row_lo) * D + col) =
          __floats2bfloat162_rn(o[dn][0] * inv_lo, o[dn][1] * inv_lo);
    if (row_hi < s_len)
      *reinterpret_cast<__nv_bfloat162*>(out + (qbase + row_hi) * D + col) =
          __floats2bfloat162_rn(o[dn][2] * inv_hi, o[dn][3] * inv_hi);
  }
  if (t == 0) {
    if (row_lo < s_len)
      lse[qbase + row_lo] = (m_lo + log2f(li_lo)) * (1.f / kLog2e);
    if (row_hi < s_len)
      lse[qbase + row_hi] = (m_hi + log2f(li_hi)) * (1.f / kLog2e);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int hq, int hkv, int s_len,
                      float scale_log2, float scale) {
  constexpr int ROW = Smem<D>::ROW, T32 = Smem<D>::T32, KD = D / 16;
  constexpr int QT = 32;  // q rows per step
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kRows * ROW;
  bf16* q_s = v_s + kRows * ROW;  // [32][D + 8]
  bf16* do_s = q_s + QT * ROW;
  bf16* qt_s = do_s + QT * ROW;   // Q^T [D][32 + 8]
  bf16* dot_s = qt_s + D * T32;   // dO^T
  float* lse_s = reinterpret_cast<float*>(dot_s + D * T32);
  float* dl_s = lse_s + QT;

  const int kt = blockIdx.x;  // causal: low kv tiles see the most q tiles
  const int hk = blockIdx.y, b = blockIdx.z;
  const int grp = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kRows;
  const int row_lo = k0 + warp * 16 + g, row_hi = row_lo + 8;  // kv rows
  const int nq = (s_len + QT - 1) / QT;
  const size_t kbase = ((size_t)b * hkv + hk) * s_len;

  stage<D, kRows>(k_s, k + kbase * D, k0, s_len);
  stage<D, kRows>(v_s, v + kbase * D, k0, s_len);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[dn][e] = 0.f;
      dva[dn][e] = 0.f;
    }

  for (int hi = 0; hi < grp; ++hi) {
    const size_t qbase = ((size_t)b * hq + hk * grp + hi) * s_len;
    for (int qi = CAUSAL ? k0 / QT : 0; qi < nq; ++qi) {
      const int q0 = qi * QT;
      __syncthreads();  // the previous q tile's readers are done
      stage<D, QT>(q_s, q + qbase * D, q0, s_len);
      stage<D, QT>(do_s, dout + qbase * D, q0, s_len);
      stage_t<D, QT>(qt_s, q + qbase * D, q0, s_len);
      stage_t<D, QT>(dot_s, dout + qbase * D, q0, s_len);
      if (threadIdx.x < QT) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < s_len ? lse[qbase + row] * kLog2e : 0.f;
        dl_s[threadIdx.x] = row < s_len ? delta[qbase + row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows kv, columns q.
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[nt][e] = 0.f;
          dpt[nt][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, k_s, ROW, warp * 16, kk * 16, g, t);
        load_a(va, v_s, ROW, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t b0, b1;
          load_b(b0, b1, q_s, ROW, nt * 8, kk * 16, g, t);
          mma(st[nt], ka, b0, b1);
          load_b(b0, b1, do_s, ROW, nt * 8, kk * 16, g, t);
          mma(dpt[nt], va, b0, b1);
        }
      }
      const bool masked = (CAUSAL && q0 < k0 + kRows - 1) ||
                          q0 + QT > s_len || k0 + kRows > s_len;
      uint32_t pa[2][4], dsa[2][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t + (e & 1);
          const int col = q0 + c;
          const int row = e < 2 ? row_lo : row_hi;
          float x = st[nt][e] * scale_log2;
          if (masked &&
              (col >= s_len || row >= s_len || (CAUSAL && row > col)))
            x = kNegInf;
          p[e] = exp2f(x - lse_s[c]);
          ds[e] = p[e] * (dpt[nt][e] - dl_s[c]);
        }
        pa[nt / 2][(nt % 2) * 2] = pack(p[0], p[1]);
        pa[nt / 2][(nt % 2) * 2 + 1] = pack(p[2], p[3]);
        dsa[nt / 2][(nt % 2) * 2] = pack(ds[0], ds[1]);
        dsa[nt / 2][(nt % 2) * 2 + 1] = pack(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q (k = q position).
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t b0, b1;
          load_b(b0, b1, dot_s, T32, dn * 8, kk * 16, g, t);
          mma(dva[dn], pa[kk], b0, b1);
          load_b(b0, b1, qt_s, T32, dn * 8, kk * 16, g, t);
          mma(dka[dn], dsa[kk], b0, b1);
        }
    }
  }

#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row_lo < s_len) {
      const size_t at = (kbase + row_lo) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[dn][0] * scale, dka[dn][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[dn][0], dva[dn][1]);
    }
    if (row_hi < s_len) {
      const size_t at = (kbase + row_hi) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[dn][2] * scale, dka[dn][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[dn][2], dva[dn][3]);
    }
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int hq, int hkv, int s_len, float scale_log2,
                    float scale) {
  constexpr int ROW = Smem<D>::ROW, T64 = Smem<D>::T64, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kRows * ROW;
  bf16* k_s = do_s + kRows * ROW;
  bf16* v_s = k_s + kRows * ROW;
  bf16* kt_s = v_s + kRows * ROW;  // K^T [D][64 + 8]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kRows;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const size_t qbase = ((size_t)b * hq + h) * s_len;
  const size_t kbase = ((size_t)b * hkv + hk) * s_len;

  stage<D, kRows>(q_s, q + qbase * D, q0, s_len);
  stage<D, kRows>(do_s, dout + qbase * D, q0, s_len);
  const float lse_lo = row_lo < s_len ? lse[qbase + row_lo] * kLog2e : 0.f;
  const float lse_hi = row_hi < s_len ? lse[qbase + row_hi] * kLog2e : 0.f;
  const float dl_lo = row_lo < s_len ? delta[qbase + row_lo] : 0.f;
  const float dl_hi = row_hi < s_len ? delta[qbase + row_hi] : 0.f;
  float dqa[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dn][e] = 0.f;

  const int kv_end = CAUSAL ? min(s_len, q0 + kRows) : s_len;
  for (int k0 = 0; k0 < kv_end; k0 += kRows) {
    __syncthreads();
    stage<D, kRows>(k_s, k + kbase * D, k0, s_len);
    stage<D, kRows>(v_s, v + kbase * D, k0, s_len);
    stage_t<D, kRows>(kt_s, k + kbase * D, k0, s_len);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows q, columns kv.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = 0.f;
        dp[nt][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, q_s, ROW, warp * 16, kk * 16, g, t);
      load_a(da, do_s, ROW, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, ROW, nt * 8, kk * 16, g, t);
        mma(s[nt], qa, b0, b1);
        load_b(b0, b1, v_s, ROW, nt * 8, kk * 16, g, t);
        mma(dp[nt], da, b0, b1);
      }
    }
    const bool masked =
        (CAUSAL && k0 + kRows - 1 > q0) || k0 + kRows > s_len;
    uint32_t dsa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        float x = s[nt][e] * scale_log2;
        if (masked && (col >= s_len || (CAUSAL && col > row))) x = kNegInf;
        const float p = exp2f(x - (e < 2 ? lse_lo : lse_hi));
        ds[e] = p * (dp[nt][e] - (e < 2 ? dl_lo : dl_hi));
      }
      dsa[nt / 2][(nt % 2) * 2] = pack(ds[0], ds[1]);
      dsa[nt / 2][(nt % 2) * 2 + 1] = pack(ds[2], ds[3]);
    }

    // dQ += dS K (k = kv position).
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        load_b(b0, b1, kt_s, T64, dn * 8, kk * 16, g, t);
        mma(dqa[dn], dsa[kk], b0, b1);
      }
  }

#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row_lo < s_len)
      *reinterpret_cast<__nv_bfloat162*>(dq + (qbase + row_lo) * D + col) =
          __floats2bfloat162_rn(dqa[dn][0] * scale, dqa[dn][1] * scale);
    if (row_hi < s_len)
      *reinterpret_cast<__nv_bfloat162*>(dq + (qbase + row_hi) * D + col) =
          __floats2bfloat162_rn(dqa[dn][2] * scale, dqa[dn][3] * scale);
  }
}

bool shapes_ok(int b, int hq, int hkv, int s_len) {
  return b > 0 && b <= 65535 && hkv > 0 && hq > 0 && hq <= 65535 &&
         hq % hkv == 0 && s_len > 0;
}

// Each kernel's dynamic shared memory can pass the 48 KB static limit, so
// every launch raises the kernel's limit first.
template <typename Kernel>
int launch_prepare(Kernel kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int D, bool CAUSAL>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int b, int hq, int hkv, int s_len, float scale, cudaStream_t st) {
  auto kernel = flash_fwd_kernel<D, CAUSAL>;
  constexpr int smem = Smem<D>::fwd;
  if (int rc = launch_prepare(kernel, smem)) return rc;
  const dim3 grid((s_len + kRows - 1) / kRows, hq, b);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), hq, hkv, s_len, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool CAUSAL>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dk, void* dv, int b,
         int hq, int hkv, int s_len, float scale, cudaStream_t st) {
  auto kernel = flash_bwd_dkdv_kernel<D, CAUSAL>;
  constexpr int smem = Smem<D>::dkdv;
  if (int rc = launch_prepare(kernel, smem)) return rc;
  const dim3 grid((s_len + kRows - 1) / kRows, hkv, b);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq, hkv, s_len,
      scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool CAUSAL>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int b, int hq,
       int hkv, int s_len, float scale, cudaStream_t st) {
  auto kernel = flash_bwd_dq_kernel<D, CAUSAL>;
  constexpr int smem = Smem<D>::dq;
  if (int rc = launch_prepare(kernel, smem)) return rc;
  const dim3 grid((s_len + kRows - 1) / kRows, hq, b);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq_out), hq, hkv, s_len, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int b, int hq, int hkv,
                         int s_len, int head_dim, int causal, float scale,
                         void* stream) {
  if (!shapes_ok(b, hq, hkv, s_len)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim * 2 + (causal ? 1 : 0)) {
    case 64 * 2:
      return fwd<64, false>(q, k, v, out, lse, b, hq, hkv, s_len, scale, st);
    case 64 * 2 + 1:
      return fwd<64, true>(q, k, v, out, lse, b, hq, hkv, s_len, scale, st);
    case 128 * 2:
      return fwd<128, false>(q, k, v, out, lse, b, hq, hkv, s_len, scale, st);
    case 128 * 2 + 1:
      return fwd<128, true>(q, k, v, out, lse, b, hq, hkv, s_len, scale, st);
    default:
      return -2;
  }
}

extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int b,
                              int hq, int hkv, int s_len, int head_dim,
                              int causal, float scale, void* stream) {
  if (!shapes_ok(b, hq, hkv, s_len)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim * 2 + (causal ? 1 : 0)) {
    case 64 * 2:
      return dkdv<64, false>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv,
                             s_len, scale, st);
    case 64 * 2 + 1:
      return dkdv<64, true>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv,
                            s_len, scale, st);
    case 128 * 2:
      return dkdv<128, false>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv,
                              s_len, scale, st);
    case 128 * 2 + 1:
      return dkdv<128, true>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv,
                             s_len, scale, st);
    default:
      return -2;
  }
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq_out, int b, int hq,
                            int hkv, int s_len, int head_dim, int causal,
                            float scale, void* stream) {
  if (!shapes_ok(b, hq, hkv, s_len)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim * 2 + (causal ? 1 : 0)) {
    case 64 * 2:
      return dq<64, false>(q, k, v, dout, lse, delta, dq_out, b, hq, hkv,
                           s_len, scale, st);
    case 64 * 2 + 1:
      return dq<64, true>(q, k, v, dout, lse, delta, dq_out, b, hq, hkv,
                          s_len, scale, st);
    case 128 * 2:
      return dq<128, false>(q, k, v, dout, lse, delta, dq_out, b, hq, hkv,
                            s_len, scale, st);
    case 128 * 2 + 1:
      return dq<128, true>(q, k, v, dout, lse, delta, dq_out, b, hq, hkv,
                           s_len, scale, st);
    default:
      return -2;
  }
}
