// One kv tile of a flash-attention forward on wgmma, for a consumer
// warpgroup that owns 64 query rows: S = Q K^T, the online softmax in base
// 2 on the accumulators, and O += P V with P as the register A operand.
//
// Shared by flash_attention.cu (flash_fwd, K4) and paged_attention.cu
// (paged_prefill, K3). The caller stages Q, K and V as 128-byte swizzled
// tiles (D / 64 column blocks of 64 bf16), scales and masks the scores
// between qk_tile and softmax_tile, and decides how p is packed.

#pragma once

#include "hopper.cuh"  // mbarriers, TMA, wgmma, quad reductions

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// S (64 rows x N kv columns, f32) = Q K^T. Q rows at q_addr, K rows at
// k_addr, both K-major; q_half / k_half bytes between their 64-column
// blocks.
template <int N, int D>
__device__ __forceinline__ void qk_tile(float (&s)[N / 2], uint32_t q_addr,
                                        uint32_t q_half, uint32_t k_addr,
                                        uint32_t k_half) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qoff = (kk / 4) * q_half + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * k_half + (kk % 4) * 32;
    if constexpr (N == 128)
      wgmma_ss_n128(s, kmajor_desc(q_addr + qoff), kmajor_desc(k_addr + koff),
                    kk > 0);
    else
      wgmma_ss_n64(s, kmajor_desc(q_addr + qoff), kmajor_desc(k_addr + koff),
                   kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// The online softmax over one tile of scaled, masked scores (this thread's
// rows lo = g and hi = g + 8 of its warp's 16): new row maxima, p = 2^(s -
// m), this thread's partial row sums l (quad-summed by the caller at the
// end), the output accumulators rescaled. pack(nt, p0, p1, p2, p3, a, b)
// writes the 8-column block nt's p into A-fragment registers a (row lo)
// and b (row hi).
template <int N, int HALVES, typename Pack>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float& m_lo,
                                             float& m_hi, float& l_lo,
                                             float& l_hi,
                                             float (&o)[HALVES][32],
                                             uint32_t (&pa)[N / 16][4],
                                             Pack pack) {
  float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[nt * 4], s[nt * 4 + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[nt * 4 + 2], s[nt * 4 + 3]));
  }
  mx_lo = quad_max(mx_lo);
  mx_hi = quad_max(mx_hi);
  const float c_lo = exp2f(m_lo - mx_lo), c_hi = exp2f(m_hi - mx_hi);
  m_lo = mx_lo;
  m_hi = mx_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const float p0 = exp2f(s[nt * 4] - mx_lo);
    const float p1 = exp2f(s[nt * 4 + 1] - mx_lo);
    const float p2 = exp2f(s[nt * 4 + 2] - mx_hi);
    const float p3 = exp2f(s[nt * 4 + 3] - mx_hi);
    sum_lo += p0 + p1;
    sum_hi += p2 + p3;
    pack(nt, p0, p1, p2, p3, pa[nt / 2][(nt % 2) * 2],
         pa[nt / 2][(nt % 2) * 2 + 1]);
  }
  l_lo = l_lo * c_lo + sum_lo;
  l_hi = l_hi * c_hi + sum_hi;
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh) {
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      o[hh][dn * 4] *= c_lo;
      o[hh][dn * 4 + 1] *= c_lo;
      o[hh][dn * 4 + 2] *= c_hi;
      o[hh][dn * 4 + 3] *= c_hi;
    }
    fence_regs(o[hh]);
  }
}

// O[:, half] += P V[:, half] over the tile's N kv rows; V read as stored
// ([kv][D], MN-major through the descriptor), v_half bytes between its
// 64-column blocks; F16 takes P and V as f16, else bf16.
template <int N, int HALVES, bool F16>
__device__ __forceinline__ void pv_tile(float (&o)[HALVES][32],
                                        uint32_t (&pa)[N / 16][4],
                                        uint32_t v_addr, uint32_t v_half) {
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t dv =
          mnmajor_desc(v_addr + hh * v_half + kk * 16 * kRowBytes, v_half);
      if constexpr (F16)
        wgmma_rs_n64_tb_f16(o[hh], pa[kk], dv);
      else
        wgmma_rs_n64_tb(o[hh], pa[kk], dv);
    }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh) fence_regs(o[hh]);
}

// p rounded to bf16 pairs, as flash_fwd and the bf16 paged_prefill use it.
struct PackBf16 {
  __device__ __forceinline__ void operator()(int, float p0, float p1,
                                             float p2, float p3, uint32_t& a,
                                             uint32_t& b) const {
    a = pack(p0, p1);
    b = pack(p2, p3);
  }
};

}  // namespace
