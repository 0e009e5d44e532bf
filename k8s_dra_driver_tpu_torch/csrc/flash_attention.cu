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
// products must run on the tensor cores at the rate only wgmma reaches.
//
// All three kernels: wgmma, TMA and warp specialisation (the shape of
// FlashAttention-3, without its intra-warpgroup pipelining):
//   - A block has 3 warpgroups. Warpgroup 0 is the producer: one thread
//     issues every TMA load (in the backward its warp's lanes also load the
//     lse and delta rows), the rest idle; setmaxnreg gives it 40 registers
//     a thread. Warpgroups 1 and 2 are consumers of 64 rows each (232).
//   - Tiles come in by TMA through rank-3 tensor maps over [B*H, S, D]
//     (the ragged S tail of each head is zero-filled, never the next
//     head's rows), in 128-byte swizzled boxes of 64 columns: a D-128 row
//     is two boxes. The wgmma descriptors name the same 128-byte swizzle.
//   - Loads overlap products through a ring (2 stages, 4 in dQ) guarded by
//     full and empty mbarriers (TMA completes `full`; the 8 consumer warps
//     arrive on `empty` once their products have read the stage).
//   - Score tiles never leave registers: the f32 accumulator of S (or
//     S^T) for two neighbouring 8-column blocks is the register A operand
//     of the next wgmma's 16-deep k-step, so p and dS are packed to bf16
//     in place -- the bf16 rounding the Pallas kernels apply.
//   - No operand is transposed while staged. Products whose B operand
//     would need a transpose (V in O += P V, dO in dV += P^T dO, Q in
//     dK += dS^T Q, K in dQ += dS K) read it as stored through the
//     descriptor's transpose (MN-major) mode.
//   flash_fwd:      one block per (q tile of 128, q head, batch); Q loaded
//                   once, K and V tiles of 128 through the ring up to the
//                   diagonal; S = Q K^T by wgmma m64n128k16 (A and B from
//                   shared memory), online softmax in base 2 (LOG2E folded
//                   into the scale), O += P V by wgmma m64n64k16 per
//                   64-column half of D with P from registers; out = O / l,
//                   lse = (m + log2 l) / LOG2E. That tile step is
//                   attention_tile.cuh's, shared with paged_prefill.
//   flash_bwd_dkdv: one block per (kv tile of 128, kv head, batch); K and V
//                   stay in shared memory; the loop over the G query heads
//                   of the group and the q tiles of 64 from the diagonal on
//                   brings Q, dO (TMA) and lse, delta (the producer warp's
//                   loads) through the ring; S^T = K Q^T and dP^T = V dO^T
//                   by wgmma m64n64k16, then dV += P^T dO and dK += dS^T Q
//                   with P^T and dS^T from registers. dK and dV sum over the
//                   whole query group in f32 registers (no atomics).
//   flash_bwd_dq:   one block per (q tile of 128, q head, batch); Q, dO and
//                   the tile's lse and delta rows loaded once, K and V tiles
//                   of 64 through a 4-stage ring up to the diagonal (a
//                   consumer skips the tiles wholly above its own 64 rows);
//                   S = Q K^T and dP = dO V^T by wgmma m64n64k16, dS = P (dP
//                   - delta) packed in registers, dQ += dS K by wgmma
//                   m64n64k16 per 64-column half of D (attention_tile.cuh's
//                   pv_tile with K in V's place). dQ stays in f32 registers
//                   and is scaled and stored once. Not fused into dK/dV (as
//                   FlashAttention-2/3 do with f32 atomic adds on dQ): the
//                   three-kernel split of the reference keeps every output
//                   bitwise equal from call to call.
// The backward rebuilds p = exp2(s * scale * LOG2E - lse * LOG2E) and masks
// BEFORE the exp2: a masked score can exceed lse, and its exp2 would be inf.
// Tiles wholly below the diagonal run unmasked; only the tiles on the
// diagonal and the ragged last tile pay for the mask. Causal grids start with
// the tiles that have the most work.

#include "attention_tile.cuh"  // qk_tile, softmax_tile, pv_tile; through
                               // hopper.cuh mbarriers, TMA, wgmma,
                               // setmaxnreg, tensor maps

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// The three kernels: wgmma and TMA (pieces from hopper.cuh).
// ---------------------------------------------------------------------------

constexpr int kTile = 128;  // rows of a K/V tile (K4, K5), a Q tile (K4, K6)

// Shared memory of flash_fwd (byte offsets from a 1024-aligned base): Q,
// then two stages of K and V, then the barriers. A tile of R rows is
// stored as D / 64 column blocks of R swizzled 128-byte rows.
template <int D>
struct FwdSmem {
  static constexpr int TILE = kTile * D * 2;  // a 128-row tile
  static constexpr int Q = 0;
  static constexpr int K0 = TILE;             // stage s: K at K0 + 2 s TILE
  static constexpr int BARS = 5 * TILE;       // q_full, full[2], empty[2]
  static constexpr int USED = BARS + 5 * 8;
  static constexpr int BYTES = USED + 1024 > kMinSmem ? USED + 1024
                                                      : kMinSmem;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 bf16* __restrict__ out, float* __restrict__ lse, int hq,
                 int hkv, int s_len, float scale_log2) {
  using L = FwdSmem<D>;
  constexpr int HALVES = D / 64;
  constexpr int HALF = kTile * kRowBytes;  // one 64-column block of a tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 3;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kTile;
  const int kv_end = CAUSAL ? min(s_len, q0 + kTile) : s_len;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: Q once, then K and V tile by tile through the ring.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::TILE);
      for (int hh = 0; hh < HALVES; ++hh)
        tma_load(smem + L::Q + hh * HALF, &q_map, q_full, hh * 64, q0,
                 b * hq + h);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j & 1;
        mbar_wait(&empty[st], ((j >> 1) & 1) ^ 1);
        unsigned char* kt = smem + L::K0 + st * 2 * L::TILE;
        unsigned char* vt = kt + L::TILE;
        mbar_expect_tx(&full[st], 2 * L::TILE);
        for (int hh = 0; hh < HALVES; ++hh) {
          tma_load(kt + hh * HALF, &k_map, &full[st], hh * 64, j * kTile,
                   b * hkv + hk);
          tma_load(vt + hh * HALF, &v_map, &full[st], hh * 64, j * kTile,
                   b * hkv + hk);
        }
      }
    }
  } else {
    // Consumer warpgroup c owns q rows q0 + 64 c .. + 63.
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tw = threadIdx.x % 128;
    const int warp = tw >> 5, lane = tw & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qc = q0 + 64 * c;
    const int row_lo = qc + warp * 16 + g, row_hi = row_lo + 8;
    const uint32_t q_addr = smem_u32(smem + L::Q) + c * 64 * kRowBytes;

    float o[HALVES][32];
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j & 1;
      mbar_wait(&full[st], (j >> 1) & 1);
      const uint32_t k_addr = smem_u32(smem + L::K0 + st * 2 * L::TILE);
      const uint32_t v_addr = k_addr + L::TILE;

      // S = Q K^T: 64 q rows x 128 kv columns, f32.
      float s[64];
      qk_tile<kTile, D>(s, q_addr, HALF, k_addr, HALF);

      const int k0 = j * kTile;
      const bool masked =
          (CAUSAL && k0 + kTile - 1 > qc) || k0 + kTile > s_len;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          float x = s[nt * 4 + e] * scale_log2;
          if (masked && (col >= s_len || (CAUSAL && col > row))) x = kNegInf;
          s[nt * 4 + e] = x;
        }

      // p in place as the register A operand of O += P V (k = kv position).
      uint32_t pa[8][4];
      softmax_tile<kTile, HALVES>(s, m_lo, m_hi, l_lo, l_hi, o, pa,
                                  PackBf16());
      pv_tile<kTile, HALVES, false>(o, pa, v_addr, HALF);
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with it
    }

    const float li_lo = fmaxf(quad_sum(l_lo), 1e-30f);
    const float li_hi = fmaxf(quad_sum(l_hi), 1e-30f);
    const float inv_lo = 1.f / li_lo, inv_hi = 1.f / li_hi;
    const size_t qbase = ((size_t)b * hq + h) * s_len;
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        const int col = hh * 64 + dn * 8 + 2 * t;
        if (row_lo < s_len)
          *reinterpret_cast<__nv_bfloat162*>(out + (qbase + row_lo) * D +
                                             col) =
              __floats2bfloat162_rn(o[hh][dn * 4] * inv_lo,
                                    o[hh][dn * 4 + 1] * inv_lo);
        if (row_hi < s_len)
          *reinterpret_cast<__nv_bfloat162*>(out + (qbase + row_hi) * D +
                                             col) =
              __floats2bfloat162_rn(o[hh][dn * 4 + 2] * inv_hi,
                                    o[hh][dn * 4 + 3] * inv_hi);
      }
    if (t == 0) {
      if (row_lo < s_len)
        lse[qbase + row_lo] = (m_lo + log2f(li_lo)) * (1.f / kLog2e);
      if (row_hi < s_len)
        lse[qbase + row_hi] = (m_hi + log2f(li_hi)) * (1.f / kLog2e);
    }
  }
}

// Shared memory of flash_bwd_dkdv (byte offsets from a 1024-aligned base):
// K and V (resident), two stages of Q and dO tiles of 64 rows, the two
// stages' lse and delta rows, then the barriers.
template <int D>
struct DkdvSmem {
  static constexpr int QT = 64;                 // q rows per step
  static constexpr int KV = kTile * D * 2;      // a 128-row K or V tile
  static constexpr int QTILE = QT * D * 2;      // a 64-row Q or dO tile
  static constexpr int K = 0, V = KV;
  static constexpr int STAGE0 = 2 * KV;         // stage s: Q, then dO
  static constexpr int ROWS = STAGE0 + 4 * QTILE;  // stage s: lse, delta
  static constexpr int BARS = ROWS + 2 * 2 * QT * 4;  // kv_full, full, empty
  static constexpr int USED = BARS + 5 * 8;
  static constexpr int BYTES = USED + 1024 > kMinSmem ? USED + 1024
                                                      : kMinSmem;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int hq, int hkv, int s_len,
                      float scale_log2, float scale) {
  using L = DkdvSmem<D>;
  constexpr int HALVES = D / 64, KSTEPS = D / 16, QT = L::QT;
  constexpr int KV_HALF = kTile * kRowBytes;  // 64 columns of a K/V tile
  constexpr int Q_HALF = QT * kRowBytes;      // 64 columns of a Q/dO tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 3;

  const int kt = blockIdx.x;  // causal: low kv tiles see the most q tiles
  const int hk = blockIdx.y, b = blockIdx.z;
  const int grp = hq / hkv;
  const int k0 = kt * kTile;
  const int nq = (s_len + QT - 1) / QT;
  const int qi0 = CAUSAL ? k0 / QT : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread, then the 32 row loads
      mbar_init(&empty[s], 8);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer warp: K and V once; then per (query head, q tile) Q and dO
    // by TMA and the tile's lse (times LOG2E) and delta rows by its lanes.
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::KV);
        for (int hh = 0; hh < HALVES; ++hh) {
          tma_load(smem + L::K + hh * KV_HALF, &k_map, kv_full, hh * 64, k0,
                   b * hkv + hk);
          tma_load(smem + L::V + hh * KV_HALF, &v_map, kv_full, hh * 64, k0,
                   b * hkv + hk);
        }
      }
      int it = 0;
      for (int hi = 0; hi < grp; ++hi) {
        const int head = b * hq + hk * grp + hi;
        for (int qi = qi0; qi < nq; ++qi, ++it) {
          const int st = it & 1;
          mbar_wait(&empty[st], ((it >> 1) & 1) ^ 1);
          unsigned char* qs = smem + L::STAGE0 + st * 2 * L::QTILE;
          if (lane == 0) {
            mbar_expect_tx(&full[st], 2 * L::QTILE);
            for (int hh = 0; hh < HALVES; ++hh) {
              tma_load(qs + hh * Q_HALF, &q_map, &full[st], hh * 64,
                       qi * QT, head);
              tma_load(qs + L::QTILE + hh * Q_HALF, &do_map, &full[st],
                       hh * 64, qi * QT, head);
            }
          }
          float* rows = reinterpret_cast<float*>(smem + L::ROWS) +
                        st * 2 * QT;
          for (int r = lane; r < QT; r += 32) {
            const int row = qi * QT + r;
            const size_t at = (size_t)head * s_len + row;
            rows[r] = row < s_len ? lse[at] * kLog2e : 0.f;
            rows[QT + r] = row < s_len ? delta[at] : 0.f;
          }
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    // Consumer warpgroup c owns kv rows k0 + 64 c .. + 63.
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tw = threadIdx.x % 128;
    const int warp = tw >> 5, lane = tw & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kc = k0 + 64 * c;
    const int row_lo = kc + warp * 16 + g, row_hi = row_lo + 8;  // kv rows
    const uint32_t k_addr = smem_u32(smem + L::K) + c * 64 * kRowBytes;
    const uint32_t v_addr = smem_u32(smem + L::V) + c * 64 * kRowBytes;

    float dka[HALVES][32], dva[HALVES][32];
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dka[hh][i] = 0.f;
        dva[hh][i] = 0.f;
      }

    mbar_wait(kv_full, 0);
    int it = 0;
    for (int hi = 0; hi < grp; ++hi) {
      for (int qi = qi0; qi < nq; ++qi, ++it) {
        const int st = it & 1;
        const int q0 = qi * QT;
        mbar_wait(&full[st], (it >> 1) & 1);
        const uint32_t q_addr =
            smem_u32(smem + L::STAGE0 + st * 2 * L::QTILE);
        const uint32_t do_addr = q_addr + L::QTILE;
        const float* lse_s =
            reinterpret_cast<const float*>(smem + L::ROWS) + st * 2 * QT;
        const float* dl_s = lse_s + QT;

        // S^T = K Q^T and dP^T = V dO^T: rows kv, columns q.
        float st_[32], dpt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          st_[i] = 0.f;
          dpt[i] = 0.f;
        }
        fence_regs(st_);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const uint32_t kv_off = (kk / 4) * KV_HALF + (kk % 4) * 32;
          const uint32_t q_off = (kk / 4) * Q_HALF + (kk % 4) * 32;
          wgmma_ss_n64(st_, kmajor_desc(k_addr + kv_off),
                       kmajor_desc(q_addr + q_off), kk > 0);
          wgmma_ss_n64(dpt, kmajor_desc(v_addr + kv_off),
                       kmajor_desc(do_addr + q_off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st_);
        fence_regs(dpt);

        const bool masked = (CAUSAL && q0 < kc + 63) || q0 + QT > s_len ||
                            kc + 64 > s_len;
        uint32_t pa[4][4], dsa[4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ci = nt * 8 + 2 * t + (e & 1);
            const int col = q0 + ci;
            const int row = e < 2 ? row_lo : row_hi;
            float x = st_[nt * 4 + e] * scale_log2;
            if (masked &&
                (col >= s_len || row >= s_len || (CAUSAL && row > col)))
              x = kNegInf;
            p[e] = exp2f(x - lse_s[ci]);
            ds[e] = p[e] * (dpt[nt * 4 + e] - dl_s[ci]);
          }
          pa[nt / 2][(nt % 2) * 2] = pack(p[0], p[1]);
          pa[nt / 2][(nt % 2) * 2 + 1] = pack(p[2], p[3]);
          dsa[nt / 2][(nt % 2) * 2] = pack(ds[0], ds[1]);
          dsa[nt / 2][(nt % 2) * 2 + 1] = pack(ds[2], ds[3]);
        }

        // dV += P^T dO and dK += dS^T Q (k = q position), dO and Q read as
        // stored ([q][D], transposed by the descriptor).
        fence_regs(pa);
        fence_regs(dsa);
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh) {
          fence_regs(dka[hh]);
          fence_regs(dva[hh]);
        }
        wgmma_fence();
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t off = hh * Q_HALF + kk * 16 * kRowBytes;
            wgmma_rs_n64_tb(dva[hh], pa[kk], mnmajor_desc(do_addr + off,
                                                          Q_HALF));
            wgmma_rs_n64_tb(dka[hh], dsa[kk], mnmajor_desc(q_addr + off,
                                                           Q_HALF));
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh) {
          fence_regs(dka[hh]);
          fence_regs(dva[hh]);
        }
        if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with it
      }
    }

    const size_t kbase = ((size_t)b * hkv + hk) * s_len;
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        const int col = hh * 64 + dn * 8 + 2 * t;
        if (row_lo < s_len) {
          const size_t at = (kbase + row_lo) * D + col;
          *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
              dka[hh][dn * 4] * scale, dka[hh][dn * 4 + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(dva[hh][dn * 4], dva[hh][dn * 4 + 1]);
        }
        if (row_hi < s_len) {
          const size_t at = (kbase + row_hi) * D + col;
          *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
              dka[hh][dn * 4 + 2] * scale, dka[hh][dn * 4 + 3] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(dva[hh][dn * 4 + 2], dva[hh][dn * 4 + 3]);
        }
      }
  }
}

// Shared memory of flash_bwd_dq (byte offsets from a 1024-aligned base): Q
// and dO (resident, 128 rows each), DqSmem::STAGES stages of K and V tiles
// of 64 rows, the block's lse and delta rows, then the barriers.
template <int D>
struct DqSmem {
  static constexpr int KT = 64;                  // kv rows per step
  static constexpr int STAGES = 4;
  static constexpr int QTILE = kTile * D * 2;    // a 128-row Q or dO tile
  static constexpr int KVTILE = KT * D * 2;      // a 64-row K or V tile
  static constexpr int Q = 0, DO = QTILE;
  static constexpr int STAGE0 = 2 * QTILE;       // stage s: K, then V
  static constexpr int ROWS = STAGE0 + STAGES * 2 * KVTILE;  // lse, delta
  static constexpr int BARS = ROWS + 2 * kTile * 4;  // q_full, full, empty
  static constexpr int USED = BARS + (1 + 2 * STAGES) * 8;
  static constexpr int BYTES = USED + 1024 > kMinSmem ? USED + 1024
                                                      : kMinSmem;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int hq, int hkv, int s_len, float scale_log2,
                    float scale) {
  using L = DqSmem<D>;
  constexpr int HALVES = D / 64, KT = L::KT, STAGES = L::STAGES;
  constexpr int Q_HALF = kTile * kRowBytes;  // 64 columns of a Q/dO tile
  constexpr int KV_HALF = KT * kRowBytes;    // 64 columns of a K/V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;
  float* rows = reinterpret_cast<float*>(smem + L::ROWS);  // lse, delta

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kTile;
  const int kv_end = CAUSAL ? min(s_len, q0 + kTile) : s_len;
  const int n_tiles = (kv_end + KT - 1) / KT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1 + 32);  // the TMA thread, then the 32 row loads
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer warp: Q and dO once by TMA and the tile's lse (times LOG2E)
    // and delta rows by its lanes; then K and V tile by tile through the
    // ring.
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(q_full, 2 * L::QTILE);
        for (int hh = 0; hh < HALVES; ++hh) {
          tma_load(smem + L::Q + hh * Q_HALF, &q_map, q_full, hh * 64, q0,
                   b * hq + h);
          tma_load(smem + L::DO + hh * Q_HALF, &do_map, q_full, hh * 64, q0,
                   b * hq + h);
        }
      }
      const size_t qbase = ((size_t)b * hq + h) * s_len;
      for (int r = lane; r < kTile; r += 32) {
        const int row = q0 + r;
        rows[r] = row < s_len ? lse[qbase + row] * kLog2e : 0.f;
        rows[kTile + r] = row < s_len ? delta[qbase + row] : 0.f;
      }
      mbar_arrive(q_full);
      if (lane == 0) {
        for (int j = 0; j < n_tiles; ++j) {
          const int st = j % STAGES;
          mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
          unsigned char* kt = smem + L::STAGE0 + st * 2 * L::KVTILE;
          unsigned char* vt = kt + L::KVTILE;
          mbar_expect_tx(&full[st], 2 * L::KVTILE);
          for (int hh = 0; hh < HALVES; ++hh) {
            tma_load(kt + hh * KV_HALF, &k_map, &full[st], hh * 64, j * KT,
                     b * hkv + hk);
            tma_load(vt + hh * KV_HALF, &v_map, &full[st], hh * 64, j * KT,
                     b * hkv + hk);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup c owns q rows q0 + 64 c .. + 63.
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tw = threadIdx.x % 128;
    const int warp = tw >> 5, lane = tw & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qc = q0 + 64 * c;
    const int row_lo = qc + warp * 16 + g, row_hi = row_lo + 8;
    const uint32_t q_addr = smem_u32(smem + L::Q) + c * 64 * kRowBytes;
    const uint32_t do_addr = smem_u32(smem + L::DO) + c * 64 * kRowBytes;

    float dqa[HALVES][32];
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[hh][i] = 0.f;

    mbar_wait(q_full, 0);
    const float lse_lo = rows[row_lo - q0], lse_hi = rows[row_hi - q0];
    const float dl_lo = rows[kTile + row_lo - q0];
    const float dl_hi = rows[kTile + row_hi - q0];
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const int k0 = j * KT;
      mbar_wait(&full[st], (j / STAGES) & 1);
      // A tile wholly above this warpgroup's diagonal, or rows wholly past
      // S, add nothing.
      if (qc < s_len && !(CAUSAL && k0 > qc + 63)) {
        const uint32_t k_addr =
            smem_u32(smem + L::STAGE0 + st * 2 * L::KVTILE);
        const uint32_t v_addr = k_addr + L::KVTILE;

        // S = Q K^T and dP = dO V^T: rows q, columns kv.
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = 0.f;
          dp[i] = 0.f;
        }
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t q_off = (kk / 4) * Q_HALF + (kk % 4) * 32;
          const uint32_t kv_off = (kk / 4) * KV_HALF + (kk % 4) * 32;
          wgmma_ss_n64(s, kmajor_desc(q_addr + q_off),
                       kmajor_desc(k_addr + kv_off), kk > 0);
          wgmma_ss_n64(dp, kmajor_desc(do_addr + q_off),
                       kmajor_desc(v_addr + kv_off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // dS = P (dP - delta), packed in place as the register A operand
        // of dQ += dS K (k = kv position).
        const bool masked =
            (CAUSAL && k0 + KT - 1 > qc) || k0 + KT > s_len;
        uint32_t dsa[4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + nt * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row_lo : row_hi;
            float x = s[nt * 4 + e] * scale_log2;
            if (masked && (col >= s_len || (CAUSAL && col > row)))
              x = kNegInf;
            const float p = exp2f(x - (e < 2 ? lse_lo : lse_hi));
            ds[e] = p * (dp[nt * 4 + e] - (e < 2 ? dl_lo : dl_hi));
          }
          dsa[nt / 2][(nt % 2) * 2] = pack(ds[0], ds[1]);
          dsa[nt / 2][(nt % 2) * 2 + 1] = pack(ds[2], ds[3]);
        }
        // K read as stored ([kv][D], MN-major through the descriptor).
        pv_tile<KT, HALVES, false>(dqa, dsa, k_addr, KV_HALF);
      }
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with it
    }

    const size_t qbase = ((size_t)b * hq + h) * s_len;
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        const int col = hh * 64 + dn * 8 + 2 * t;
        if (row_lo < s_len)
          *reinterpret_cast<__nv_bfloat162*>(dq + (qbase + row_lo) * D +
                                             col) =
              __floats2bfloat162_rn(dqa[hh][dn * 4] * scale,
                                    dqa[hh][dn * 4 + 1] * scale);
        if (row_hi < s_len)
          *reinterpret_cast<__nv_bfloat162*>(dq + (qbase + row_hi) * D +
                                             col) =
              __floats2bfloat162_rn(dqa[hh][dn * 4 + 2] * scale,
                                    dqa[hh][dn * 4 + 3] * scale);
      }
  }
}

bool shapes_ok(int b, int hq, int hkv, int s_len) {
  return b > 0 && b <= 65535 && hkv > 0 && hq > 0 && hq <= 65535 &&
         hq % hkv == 0 && s_len > 0;
}

// Each kernel's dynamic shared memory can pass the 48 KB static limit, so
// every launch raises the kernel's limit first -- before any tensor map is
// encoded: this runtime call binds the device's context to the calling
// thread, which the driver's encoder needs (autograd runs a backward on a
// thread of its own).
template <typename Kernel>
int launch_prepare(Kernel kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// A rank-3 map over [heads, S, D] bf16 (D contiguous) in boxes of `rows` x
// 64 columns with the 128-byte swizzle; rows past S read as zeros.
int tensor_map(CUtensorMap* map, const void* base, int heads, int s_len,
               int d, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s_len),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s_len) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return bf16_tensor_map(map, base, 3, dims, strides, box);
}

template <int D, bool CAUSAL>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int b, int hq, int hkv, int s_len, float scale, cudaStream_t st) {
  auto kernel = flash_fwd_kernel<D, CAUSAL>;
  constexpr int smem = FwdSmem<D>::BYTES;
  if (int rc = launch_prepare(kernel, smem)) return rc;
  CUtensorMap qm, km, vm;
  if (int rc = tensor_map(&qm, q, b * hq, s_len, D, kTile)) return rc;
  if (int rc = tensor_map(&km, k, b * hkv, s_len, D, kTile)) return rc;
  if (int rc = tensor_map(&vm, v, b * hkv, s_len, D, kTile)) return rc;
  const dim3 grid((s_len + kTile - 1) / kTile, hq, b);
  kernel<<<grid, kWgThreads, smem, st>>>(
      qm, km, vm, static_cast<bf16*>(out), static_cast<float*>(lse), hq, hkv,
      s_len, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool CAUSAL>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dk, void* dv, int b,
         int hq, int hkv, int s_len, float scale, cudaStream_t st) {
  auto kernel = flash_bwd_dkdv_kernel<D, CAUSAL>;
  constexpr int smem = DkdvSmem<D>::BYTES;
  if (int rc = launch_prepare(kernel, smem)) return rc;
  CUtensorMap qm, km, vm, dom;
  constexpr int QT = DkdvSmem<D>::QT;
  if (int rc = tensor_map(&qm, q, b * hq, s_len, D, QT)) return rc;
  if (int rc = tensor_map(&km, k, b * hkv, s_len, D, kTile)) return rc;
  if (int rc = tensor_map(&vm, v, b * hkv, s_len, D, kTile)) return rc;
  if (int rc = tensor_map(&dom, dout, b * hq, s_len, D, QT)) return rc;
  const dim3 grid((s_len + kTile - 1) / kTile, hkv, b);
  kernel<<<grid, kWgThreads, smem, st>>>(
      qm, km, vm, dom, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), hq, hkv, s_len, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool CAUSAL>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int b, int hq,
       int hkv, int s_len, float scale, cudaStream_t st) {
  auto kernel = flash_bwd_dq_kernel<D, CAUSAL>;
  constexpr int smem = DqSmem<D>::BYTES;
  if (int rc = launch_prepare(kernel, smem)) return rc;
  CUtensorMap qm, km, vm, dom;
  constexpr int KT = DqSmem<D>::KT;
  if (int rc = tensor_map(&qm, q, b * hq, s_len, D, kTile)) return rc;
  if (int rc = tensor_map(&km, k, b * hkv, s_len, D, KT)) return rc;
  if (int rc = tensor_map(&vm, v, b * hkv, s_len, D, KT)) return rc;
  if (int rc = tensor_map(&dom, dout, b * hq, s_len, D, kTile)) return rc;
  const dim3 grid((s_len + kTile - 1) / kTile, hq, b);
  kernel<<<grid, kWgThreads, smem, st>>>(
      qm, km, vm, dom, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq_out), hq, hkv,
      s_len, scale * kLog2e, scale);
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
