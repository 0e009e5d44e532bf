// Paged attention for Hopper (sm_90a): the single-token decode kernel and
// the multi-token prefill kernel over one paged KV pool.
//
// Replaces:
//   paged_decode  <- k8s_dra_driver_tpu/ops/attention.py::_paged_decode_kernel
//   paged_prefill <- k8s_dra_driver_tpu/ops/attention.py::_paged_prefill_kernel
//   paged_decode_int8, paged_prefill_int8 <- the `quantized` branches of the
//                    same two kernels (int8 pools with per-position scales)
//
// Layouts are the JAX package's:
//   q        [B, Hq, T, D] bf16 (decode: T = 1, the same memory as [B, Hq, D])
//   k/v pool [H_kv, P, D] bf16, flat token rows; pool block n owns rows
//            [n*bs, (n+1)*bs); the int8 branch: int8 pools with f32 scales
//            k_scale/v_scale [H_kv, P], one per position and kv head
//   tables   [B, NBPS] int32 pool-block ids; entries past a sequence's
//            valid prefix are sentinel 0 and are never read here
//   decode:  valid_len [B] int32, kv positions < valid_len are visible
//   prefill: start [B] int32, query i sits at absolute position start + i
//            and sees kv positions <= start + i
//   out      shaped like q, bf16
// Query head hq_idx reads kv head hq_idx / G (G = Hq / H_kv, "grouped by kv
// head"), so a block serves the G query heads of one kv head and reads each
// K/V row once for all of them.
//
// What bounds them on the H100. Decode reads K and V of every sequence's
// valid prefix once (sum(valid_len) * H_kv * D * 2 * 2 bytes) and does
// 4 G operations per 4 bytes: bound by bytes. Prefill at a 128-token chunk
// does 4 * G * T operations per kv byte: bound by operations once the
// tensor cores do them.
//
// paged_decode (K2), split-KV ("flash-decoding"), CUDA cores:
//   - Grid (S, H_kv, B). The host picks S from B, H_kv, NBPS, block_size
//     and the SM count only (ops/attention.py::decode_splits), never from
//     valid_len, so a decode step never waits on the host. Each block
//     computes its share of valid_len[b] itself: splits of ceil(valid_len
//     / S) rounded up to kSplitAlign positions; a split past valid_len
//     writes an empty partial (m = -inf, l = 0, acc = 0).
//   - A block is 4 consumer warps and a producer warp. The producer holds
//     32 table entries in a register, one a lane (one coalesced load, read
//     once per pool block), and fills a 4-stage ring of 32 positions with
//     bulk copies (cp.async.bulk, no tensor map): one of K and one of V
//     for each pool block, or part of one, a stage covers -- a pool block
//     of one kv head is contiguous. int8: the producer's lanes also stage
//     the positions' k and v scales.
//   - A row of 128 bf16 is 16 lanes x one 16-byte read (64: 8 lanes), so a
//     warp takes 2 (4) rows a step, each lane group with its own online
//     softmax; each warp takes 8 rows of every stage into registers and
//     hands the stage back before computing. The int8 branch keeps the
//     same lanes with 8-byte reads: 16 values a lane would pass 255
//     registers at G 8 (q and the f32 accumulators of G heads x 16
//     columns). Unrolled register loads straight from the pool, two
//     iterations in flight, measured 1-12% slower on the H100 (PERF.md).
//   - Scores are summed across the row's lanes by xor shuffles (every lane
//     ends with the same sum); the softmax is f32, base 2, in registers,
//     with no block barrier in the walk. The lane groups merge by
//     shuffles and the 4 warps once through shared memory, in a fixed
//     order.
//   - S > 1: the block writes its f32 partial (m, l, acc [G, D]) to scratch
//     the wrapper allocates; paged_decode_merge_kernel combines the S
//     partials of each (sequence, head) in split order. It is launched as
//     a programmatic dependent (griddepcontrol), so its launch overlaps the
//     split kernel's end. No float atomics: the same inputs give the same
//     bits on every call. S = 1 writes out directly.
//   - int8: 1 byte a value. k's per-position scale multiplies the finished
//     score (after the softmax scale, folded into q), v's multiplies each
//     probability after the row sum l, and the probabilities stay f32 into
//     P V -- the TPU kernel's algebra.
//
// paged_prefill (K3), wgmma + TMA, K4's shape (flash_attention.cu):
//   - A block owns one (query tile, kv head, sequence) and 128 M rows: the
//     G query heads of the kv head x TQ = 128 / G tokens (4 heads x 32
//     tokens at G 4), head-major. Two consumer warpgroups of 64 rows, a
//     producer warpgroup (setmaxnreg 40 / 232).
//   - Q comes in once by a rank-3 TMA box over [B*Hq, T, D] covering G heads
//     x TQ tokens (zero-filled past T). K and V come through a 2-stage ring
//     of KT-row tiles: the producer warp's lanes each read one table entry
//     and issue one rank-2 TMA box over the pool viewed as [H_kv * P, D] per
//     min(KT, the largest power of two dividing bs) rows, so a box never
//     crosses a pool block. Boxes wholly past the block's last query
//     position are not loaded.
//   - S = Q K^T by wgmma (K a K-major B operand), online softmax in base 2
//     on the accumulators, P packed in place as the register A operand of
//     O += P V (V an MN-major B operand), f32 accumulators; out = O / l.
//   - Past the window: masked columns get exactly 0 in P. V rows at or past
//     the last visible position of a ragged tile may hold anything (another
//     sequence's tokens, poison, stale stage data), and 0 x NaN is NaN, so
//     the consumers zero those whole 128-byte rows in shared memory, fence
//     them into the async proxy and meet at a named barrier first. Tiles
//     wholly past the last query position are never visited; only tiles
//     that straddle the first query's position or the window's end are
//     masked. Rows of padded tokens get finite values the caller discards.
//   - int8 (KT 64): the stage lands int8 by TMA (plain boxes), the
//     consumers convert it once into swizzled 16-bit tiles (K to bf16, V to
//     f16; both exact), zeroing rows past the window, and meet at a named
//     barrier. The producer's lanes stage the tile's k and v scales. k's
//     scale multiplies the S columns; v's the P columns after l sums the raw
//     p, and P V runs in f16 (11 significant bits where bf16 keeps 8).

#include "attention_tile.cuh"  // K4's tile step (qk_tile, softmax_tile,
                               // pv_tile); through hopper.cuh mbarriers,
                               // TMA, wgmma, setmaxnreg, tensor maps

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// paged_decode: split-KV on CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = 32 * kDecodeWarps;
// Split lengths are multiples of this many positions (ops/attention.py's
// DECODE_SPLIT_ALIGN); a launch takes at most kMaxSplits splits
// (DECODE_MAX_SPLITS).
constexpr int kSplitAlign = 32;
constexpr int kMaxSplits = 512;

__device__ __forceinline__ float int8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
}

// 8 values of a row in registers -> f32: bf16 in 16 bytes, int8 in the
// first 8.
template <bool QUANT>
__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  if constexpr (QUANT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = int8_at(w.x, i);
      f[4 + i] = int8_at(w.y, i);
    }
  } else {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a shift
      f[2 * i] = __uint_as_float(words[i] << 16);
      f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
}

constexpr int kRingRows = 32;    // positions a stage holds
constexpr int kRingStages = 4;

// Dynamic shared memory of paged_decode: the ring's stages (K then V rows
// of kRingRows positions), their k and v scales (int8), the barriers.
template <int D, bool QUANT>
struct DecodeRing {
  static constexpr int RB = QUANT ? D : 2 * D;  // bytes of one row
  static constexpr int STAGE = 2 * kRingRows * RB;
  static constexpr int SCALES = kRingStages * STAGE;
  static constexpr int BARS = SCALES + kRingStages * 2 * kRingRows * 4;
  static constexpr int BYTES = BARS + 2 * kRingStages * 8;
};

template <int D, int GMAX, bool QUANT>
__global__ void __launch_bounds__(kDecodeThreads + 32)
paged_decode_kernel(const bf16* __restrict__ q,
                    const void* __restrict__ k_pool,
                    const void* __restrict__ v_pool,
                    const float* __restrict__ k_scale,  // QUANT only
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ valid_len,
                    bf16* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int hq, int hkv,
                    int pool_rows, int nbps, int block_size,
                    float scale_log2) {
  using R = DecodeRing<D, QUANT>;
  constexpr int LPR = D / 8;     // lanes of one row, 8 values each
  constexpr int RPW = 32 / LPR;  // rows a warp takes per step
  constexpr int STEPS = kRingRows / kDecodeWarps / RPW;  // a warp's, a stage
  // Steps computed together (one online-softmax update): fewer at G 8,
  // whose q and accumulators take the registers.
  constexpr int U = GMAX >= 8 && STEPS > 2 ? 2 : STEPS;
  constexpr int RB = R::RB;

  extern __shared__ __align__(128) unsigned char ring[];
  float* sc = reinterpret_cast<float*>(ring + R::SCALES);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::BARS);
  uint64_t* empty = full + kRingStages;
  __shared__ float acc_s[kDecodeWarps][GMAX][D];
  __shared__ float m_s[kDecodeWarps][GMAX], l_s[kDecodeWarps][GMAX];

  const int split = blockIdx.x, n_split = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPR, col = (lane % LPR) * 8;
  const int g = hq / hkv;
  const int span = nbps * block_size;
  const int vl = min(max(valid_len[b], 0), span);
  const int split_len =
      ((vl + n_split - 1) / n_split + kSplitAlign - 1) / kSplitAlign *
      kSplitAlign;
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, vl);
  const int n_stages = s1 > s0 ? (s1 - s0 + kRingRows - 1) / kRingRows : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kRingStages; ++i) {
      // The copying lane; with int8 also the 32 lanes that stage scales.
      mbar_init(&full[i], QUANT ? 1 + 32 : 1);
      mbar_init(&empty[i], kDecodeWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kDecodeWarps) {
    // Producer warp: 32 table entries in registers, one a lane; one bulk
    // copy of K and one of V per pool block (or part of one) a stage
    // covers.
    const int32_t* table = tables + (size_t)b * nbps;
    const size_t head_row0 = (size_t)h * pool_rows;
    int win0 = -(1 << 30), tab = 0;
    for (int j = 0; j < n_stages; ++j) {
      const int slot = j % kRingStages;
      mbar_wait(&empty[slot], ((j / kRingStages) & 1) ^ 1);
      const int p0 = s0 + j * kRingRows, p1 = min(p0 + kRingRows, s1);
      const int first_blk = p0 / block_size;
      const int last_blk = (p1 - 1) / block_size;
      if (last_blk >= win0 + 32) {  // warp-uniform
        win0 = first_blk;
        tab = win0 + lane < nbps ? table[win0 + lane] : 0;
      }
      unsigned char* kd = ring + slot * R::STAGE;
      if (lane == 0) mbar_expect_tx(&full[slot], (p1 - p0) * RB * 2);
      __syncwarp();
      for (int blk = first_blk; blk <= last_blk; ++blk) {
        const int entry = __shfl_sync(0xffffffffu, tab, blk - win0);
        const int a = max(p0, blk * block_size);
        const int e = min(p1, (blk + 1) * block_size);
        if (lane == 0) {
          const size_t row = head_row0 + (size_t)entry * block_size +
                             (a - blk * block_size);
          bulk_load(kd + (a - p0) * RB,
                    static_cast<const unsigned char*>(k_pool) + row * RB,
                    (e - a) * RB, &full[slot]);
          bulk_load(kd + kRingRows * RB + (a - p0) * RB,
                    static_cast<const unsigned char*>(v_pool) + row * RB,
                    (e - a) * RB, &full[slot]);
        }
      }
      if constexpr (QUANT) {
        const int pos = p0 + lane;  // one lane a position of the stage
        const int entry = __shfl_sync(
            0xffffffffu, tab, min(max(pos / block_size - win0, 0), 31));
        float ks = 0.f, vs = 0.f;
        if (pos < p1) {
          const size_t row =
              head_row0 + (size_t)entry * block_size + pos % block_size;
          ks = k_scale[row];
          vs = v_scale[row];
        }
        sc[(slot * 2) * kRingRows + lane] = ks;
        sc[(slot * 2 + 1) * kRingRows + lane] = vs;
        mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  // Consumers. q of the G heads at this lane's 8 columns, in base-2 units.
  float qf[GMAX][8];
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (j < g)
      raw = *reinterpret_cast<const uint4*>(
          q + (size_t)(b * hq + h * g + j) * D + col);
    unpack8<false>(raw, qf[j]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[j][e] *= scale_log2;
  }
  float acc[GMAX][8], m[GMAX], l[GMAX];
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
  }

  for (int jst = 0; jst < n_stages; ++jst) {
    const int slot = jst % kRingStages;
    mbar_wait(&full[slot], (jst / kRingStages) & 1);
    const int nlive = min(kRingRows, s1 - (s0 + jst * kRingRows));
    const unsigned char* kst = ring + slot * R::STAGE;
    // This warp's rows of the stage into registers, then the stage back.
    uint4 kr[STEPS], vr[STEPS];
    float ks[STEPS], vs[STEPS];
    bool live[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int r = warp * (kRingRows / kDecodeWarps) + u * RPW + sub;
      live[u] = r < nlive;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ks[u] = vs[u] = 0.f;
      if (live[u]) {  // rows past the split are never read
        const unsigned char* kp = kst + r * RB + col * (QUANT ? 1 : 2);
        if constexpr (QUANT) {
          const uint2 kk = *reinterpret_cast<const uint2*>(kp);
          const uint2 vv = *reinterpret_cast<const uint2*>(kp + kRingRows * RB);
          kr[u] = make_uint4(kk.x, kk.y, 0u, 0u);
          vr[u] = make_uint4(vv.x, vv.y, 0u, 0u);
          ks[u] = sc[(slot * 2) * kRingRows + r];
          vs[u] = sc[(slot * 2 + 1) * kRingRows + r];
        } else {
          kr[u] = *reinterpret_cast<const uint4*>(kp);
          vr[u] = *reinterpret_cast<const uint4*>(kp + kRingRows * RB);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);

#pragma unroll
    for (int c0 = 0; c0 < STEPS; c0 += U) {
      // Scores: this lane's 8 products, summed over the row's LPR lanes.
      float s[U][GMAX];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[8];
        unpack8<QUANT>(kr[c0 + u], kf);
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qf[j][e], kf[e], dot);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if constexpr (QUANT) dot *= ks[c0 + u];  // after the softmax scale
          s[u][j] = live[c0 + u] ? dot : kNegInf;
        }
      }
      // Online softmax over the U rows, then P V.
      float vf[U][8];
#pragma unroll
      for (int u = 0; u < U; ++u) unpack8<QUANT>(vr[c0 + u], vf[u]);
#pragma unroll
      for (int j = 0; j < GMAX; ++j) {
        float mx = m[j];
#pragma unroll
        for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][j]);
        const float corr = exp2f(m[j] - mx);
        float p[U], sum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = live[c0 + u] ? exp2f(s[u][j] - mx) : 0.f;
          sum += p[u];
        }
        l[j] = l[j] * corr + sum;  // l sums the softmax's own p
        m[j] = mx;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e] *= corr;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          // v's scale into P V, the probabilities f32.
          const float w = QUANT ? p[u] * vs[c0 + u] : p[u];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[j][e] = fmaf(w, vf[u][e], acc[j][e]);
        }
      }
    }
  }

  // Merge the warp's lane groups (same columns, other rows) by shuffles.
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < GMAX; ++j) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[j], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[j], off);
      const float mx = fmaxf(m[j], mo);
      const float a = exp2f(m[j] - mx), c = exp2f(mo - mx);
      l[j] = l[j] * a + lo * c;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[j][e], off);
        acc[j][e] = acc[j][e] * a + ao * c;
      }
      m[j] = mx;
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int j = 0; j < GMAX; ++j) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc_s[warp][j][col + e] = acc[j][e];
      if (lane == 0) {
        m_s[warp][j] = m[j];
        l_s[warp][j] = l[j];
      }
    }
  }
  named_sync(1, kDecodeThreads);  // the consumers; the producer has left

  // Merge the 4 warps in order; write out (S = 1) or this split's partial.
  for (int i = threadIdx.x; i < g * D; i += kDecodeThreads) {
    const int j = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, m_s[w][j]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float e = exp2f(m_s[w][j] - mx);
      lsum += l_s[w][j] * e;
      asum += acc_s[w][j][d] * e;
    }
    const size_t head = (size_t)b * hq + h * g + j;
    if (n_split == 1) {
      out[head * D + d] = __float2bfloat16(lsum > 0.f ? asum / lsum : 0.f);
    } else {
      const size_t at = head * n_split + split;
      part_acc[at * D + d] = asum;
      if (d == 0) {
        part_ml[2 * at] = lsum > 0.f ? mx : -INFINITY;
        part_ml[2 * at + 1] = lsum;
      }
    }
  }
  // The merge grid may launch once every block is here; it still waits
  // for this grid's end before it reads the partials.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Combines the S partials of one (sequence, query head) in split order:
// out = sum_i acc_i 2^(m_i - M) / sum_i l_i 2^(m_i - M), M = max_i m_i.
// Launched as a programmatic dependent of the split kernel, so its launch
// overlaps that kernel; griddepcontrol.wait holds it until the partials
// are written. The splits' weights are computed in parallel into shared
// memory; every thread then sums them in split order.
template <int D>
__global__ void __launch_bounds__(D)
paged_decode_merge_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          bf16* __restrict__ out, int n_split) {
  constexpr int WARPS = D / 32;
  __shared__ float w_s[kMaxSplits], lw_s[kMaxSplits], wmax_s[WARPS];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t head = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + head * n_split * 2;
  float mx = -INFINITY;
  for (int i = d; i < n_split; i += D) mx = fmaxf(mx, ml[2 * i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (d % 32 == 0) wmax_s[d / 32] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wmax_s[w]);
  for (int i = d; i < n_split; i += D) {
    // An empty split (m = -inf, l = 0) weighs 2^-inf = 0.
    const float e = mx > -INFINITY ? exp2f(ml[2 * i] - mx) : 0.f;
    w_s[i] = e;
    lw_s[i] = ml[2 * i + 1] * e;
  }
  __syncthreads();
  float lsum = 0.f, asum = 0.f;
  const float* acc = part_acc + head * n_split * D + d;
#pragma unroll 8
  for (int i = 0; i < n_split; ++i) {
    lsum += lw_s[i];
    asum += acc[(size_t)i * D] * w_s[i];
  }
  out[head * D + d] = __float2bfloat16(lsum > 0.f ? asum / lsum : 0.f);
}

template <int D, int GMAX, bool QUANT>
int decode_launch(const void* q, const void* k_pool, const void* v_pool,
                  const void* k_scale, const void* v_scale,
                  const void* tables, const void* valid_len, void* out,
                  void* part_acc, void* part_ml, int b, int hq, int hkv,
                  int pool_rows, int nbps, int block_size, int splits,
                  float scale, cudaStream_t st) {
  const dim3 grid(splits, hkv, b);
  auto kernel = paged_decode_kernel<D, GMAX, QUANT>;
  constexpr int smem = DecodeRing<D, QUANT>::BYTES;
  // The shared-memory limit once per device (a decode step's host time
  // counts: every layer launches this).
  static bool ready[64] = {};
  int dev = 0;
  if (int rc = static_cast<int>(cudaGetDevice(&dev))) return rc;
  if (dev >= 64 || !ready[dev]) {
    if (int rc = static_cast<int>(cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return rc;
    if (dev < 64) ready[dev] = true;
  }
  kernel<<<grid, kDecodeThreads + 32, smem, st>>>(
      static_cast<const bf16*>(q), k_pool, v_pool,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(valid_len), static_cast<bf16*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), hq, hkv,
      pool_rows, nbps, block_size, scale * kLog2e);
  if (splits > 1) {
    if (int rc = static_cast<int>(cudaGetLastError())) return rc;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(b * hq);
    cfg.blockDim = dim3(D);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, paged_decode_merge_kernel<D>,
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml), static_cast<bf16*>(out), splits));
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <bool QUANT>
int decode_dispatch(const void* q, const void* k_pool, const void* v_pool,
                    const void* k_scale, const void* v_scale,
                    const void* tables, const void* valid_len, void* out,
                    void* part_acc, void* part_ml, int b, int hq, int hkv,
                    int head_dim, int pool_rows, int nbps, int block_size,
                    int splits, float scale, void* stream) {
  if (b <= 0 || b > 65535 || hkv <= 0 || hkv > 65535 || hq % hkv != 0 ||
      hq / hkv > 8 || pool_rows <= 0 || nbps <= 0 || block_size <= 0 ||
      splits <= 0 || splits > kMaxSplits ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      !aligned(q, 16) || !aligned(k_pool, 16) || !aligned(v_pool, 16))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = hq / hkv;
  const int gmax = g == 1 ? 1 : g == 2 ? 2 : g <= 4 ? 4 : 8;
#define PAGED_DECODE_CASE(D_, G_)                                            \
  if (head_dim == D_ && gmax == G_)                                          \
    return decode_launch<D_, G_, QUANT>(                                     \
        q, k_pool, v_pool, k_scale, v_scale, tables, valid_len, out,         \
        part_acc, part_ml, b, hq, hkv, pool_rows, nbps, block_size, splits, \
        scale, st);
  PAGED_DECODE_CASE(64, 1)
  PAGED_DECODE_CASE(64, 2)
  PAGED_DECODE_CASE(64, 4)
  PAGED_DECODE_CASE(64, 8)
  PAGED_DECODE_CASE(128, 1)
  PAGED_DECODE_CASE(128, 2)
  PAGED_DECODE_CASE(128, 4)
  PAGED_DECODE_CASE(128, 8)
#undef PAGED_DECODE_CASE
  return -2;
}

// ---------------------------------------------------------------------------
// paged_prefill: wgmma + TMA through the block table.
// ---------------------------------------------------------------------------

constexpr int kRowsM = 128;  // M rows of a block: G heads x TQ tokens

// Shared memory of paged_prefill (byte offsets from a 1024-aligned base): Q
// (128 rows, D / 64 column blocks of 128-byte swizzled rows), two stages,
// the barriers. A stage holds the 16-bit K and V tiles wgmma reads (KT rows
// each) and, for int8, the landed int8 tiles and the tile's k and v scales.
template <int D, bool QUANT>
struct PrefillSmem {
  static constexpr int KT = QUANT ? 64 : 128;
  static constexpr int QHALF = kRowsM * kRowBytes;
  static constexpr int Q = 0;
  static constexpr int THALF = KT * kRowBytes;  // 64 columns of a tile
  static constexpr int TILE = KT * D * 2;
  // An int8 tile: boxes land in 128-byte aligned slots (TMA's alignment),
  // which only a 64-byte row in one-row boxes does not fill.
  static constexpr int RAW = QUANT ? KT * kRowBytes : 0;
  static constexpr int SCALES = QUANT ? 2 * KT * 4 : 0;
  static constexpr int STAGE =
      (2 * TILE + 2 * RAW + SCALES + 1023) / 1024 * 1024;
  static constexpr int STAGE0 = (D / 64) * QHALF;
  static constexpr int BARS = STAGE0 + 2 * STAGE;  // q_full, full[2], empty[2]
  static constexpr int USED = BARS + 5 * 8;
  static constexpr int BYTES = USED + 1024 > kMinSmem ? USED + 1024
                                                      : kMinSmem;
};

// 16 int8 values -> two 16-byte chunks of bf16 (BF16) or f16, exactly.
template <bool BF16>
__device__ __forceinline__ void convert16(const uint4& raw, uint4& lo,
                                          uint4& hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a = int8_at(w[i / 2], (i % 2) * 2);
    const float c = int8_at(w[i / 2], (i % 2) * 2 + 1);
    o[i] = BF16 ? pack(a, c) : pack_f16(a, c);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(kWgThreads, 1)
paged_prefill_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const float* __restrict__ k_scale,  // QUANT only
                     const float* __restrict__ v_scale,
                     const int32_t* __restrict__ tables,
                     const int32_t* __restrict__ start_pos,
                     bf16* __restrict__ out, int hq, int hkv, int t_len,
                     int pool_rows, int nbps, int block_size, int box_rows,
                     int tq, float scale_log2) {
  using L = PrefillSmem<D, QUANT>;
  constexpr int KT = L::KT, HALVES = D / 64;
  constexpr int NT = KT / 8;  // 8-column blocks of a score tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 3;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = hq / hkv;
  const int q0 = qt * tq;
  const int n_tok = min(tq, t_len - q0);
  const int span = nbps * block_size;
  const int first_q = start_pos[b] + q0;
  const int kv_end = min(first_q + n_tok, span);  // exclusive
  const int n_tiles = (kv_end + KT - 1) / KT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      // The TMA thread; with int8 also the 32 lanes that stage the scales.
      mbar_init(&full[s], QUANT ? 1 + 32 : 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer warp: Q once, then K and V tile by tile through the ring,
    // one box per lane and pool block (or per box_rows rows of it).
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(q_full, HALVES * kRowBytes * tq * g);
        for (int hh = 0; hh < HALVES; ++hh)
          tma_load(smem + L::Q + hh * L::QHALF, &q_map, q_full, hh * 64, q0,
                   b * hq + h * g);
      }
      const int32_t* table = tables + (size_t)b * nbps;
      const int box_bytes = QUANT ? box_rows * D : box_rows * kRowBytes;
      const int slot = (box_bytes + 127) / 128 * 128;  // int8: a box's room
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j & 1;
        const int k0 = j * KT;
        const int live = min(KT, kv_end - k0);
        const int nbox = (live + box_rows - 1) / box_rows;
        unsigned char* stage = smem + L::STAGE0 + st * L::STAGE;
        mbar_wait(&empty[st], ((j >> 1) & 1) ^ 1);
        if (lane == 0)
          mbar_expect_tx(&full[st], 2 * nbox * box_bytes * (QUANT ? 1 : HALVES));
        __syncwarp();
        for (int i = lane; i < nbox; i += 32) {
          const int pos = k0 + i * box_rows;
          const int row = h * pool_rows + table[pos / block_size] * block_size +
                          pos % block_size;
          if constexpr (QUANT) {
            unsigned char* raw = stage + 2 * L::TILE;
            tma_load(raw + i * slot, &k_map, &full[st], 0, row);
            tma_load(raw + L::RAW + i * slot, &v_map, &full[st], 0, row);
          } else {
            for (int hh = 0; hh < HALVES; ++hh) {
              tma_load(stage + hh * L::THALF + i * box_bytes, &k_map,
                       &full[st], hh * 64, row);
              tma_load(stage + L::TILE + hh * L::THALF + i * box_bytes,
                       &v_map, &full[st], hh * 64, row);
            }
          }
        }
        if constexpr (QUANT) {
          float* sc = reinterpret_cast<float*>(stage + 2 * L::TILE +
                                               2 * L::RAW);
          for (int r = lane; r < KT; r += 32) {
            const int pos = k0 + r;
            float ks = 0.f, vs = 0.f;
            if (pos < kv_end) {
              const size_t row = (size_t)h * pool_rows +
                                 (size_t)table[pos / block_size] * block_size +
                                 pos % block_size;
              ks = k_scale[row];
              vs = v_scale[row];
            }
            sc[r] = ks;
            sc[KT + r] = vs;
          }
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    // Consumer warpgroup c owns M rows 64 c .. 64 c + 63.
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tc = threadIdx.x - 128;  // 0..255 over both consumers
    const int tw = threadIdx.x % 128;
    const int warp = tw >> 5, lane = tw & 31;
    const int gq = lane >> 2, t = lane & 3;
    const int row_lo = 64 * c + warp * 16 + gq, row_hi = row_lo + 8;
    const int qpos_lo = first_q + row_lo % tq, qpos_hi = first_q + row_hi % tq;
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
      const int k0 = j * KT;
      const int live = min(KT, kv_end - k0);
      unsigned char* stage = smem + L::STAGE0 + st * L::STAGE;
      mbar_wait(&full[st], (j >> 1) & 1);
      if constexpr (QUANT) {
        // int8 -> K bf16 / V f16 in the stage's swizzled tiles; rows past
        // the window become zeros.
        constexpr int CH = D / 16;  // 16-byte int8 chunks a row
        const unsigned char* raw = stage + 2 * L::TILE;
        const int slot = (box_rows * D + 127) / 128 * 128;
        for (int w = tc; w < 2 * KT * CH; w += 256) {
          const int which = w / (KT * CH), rem = w % (KT * CH);
          const int r = rem / CH, ch = rem % CH;
          uint4 in = make_uint4(0u, 0u, 0u, 0u);
          if (r < live)
            in = *reinterpret_cast<const uint4*>(
                raw + which * L::RAW + (r / box_rows) * slot +
                (r % box_rows) * D + ch * 16);
          uint4 lo, hi;
          if (which == 0)
            convert16<true>(in, lo, hi);
          else
            convert16<false>(in, lo, hi);
          const int cidx = ch * 16, hh = cidx / 64, c16 = (cidx % 64) / 8;
          unsigned char* dst =
              stage + which * L::TILE + hh * L::THALF + r * kRowBytes;
          *reinterpret_cast<uint4*>(dst + ((c16 ^ (r & 7)) * 16)) = lo;
          *reinterpret_cast<uint4*>(dst + (((c16 + 1) ^ (r & 7)) * 16)) = hi;
        }
        fence_proxy_async();
        named_sync(1, 256);
      } else if (live < KT) {
        // Zero V rows past the window (whole 128-byte rows: the swizzle
        // moves 16-byte chunks within a row only).
        unsigned char* v_tile = stage + L::TILE;
        for (int w = tc; w < (KT - live) * HALVES * 8; w += 256) {
          const int r = live + w / (HALVES * 8), rem = w % (HALVES * 8);
          *reinterpret_cast<uint4*>(v_tile + (rem / 8) * L::THALF +
                                    r * kRowBytes + (rem % 8) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        named_sync(1, 256);
      }
      const uint32_t k_addr = smem_u32(stage);
      const uint32_t v_addr = k_addr + L::TILE;

      // S = Q K^T: 64 rows x KT kv columns, f32.
      float s[KT / 2];
      qk_tile<KT, D>(s, q_addr, L::QHALF, k_addr, L::THALF);

      const float* ks_s =
          reinterpret_cast<const float*>(stage + 2 * L::TILE + 2 * L::RAW);
      const bool masked = k0 + KT - 1 > first_q || k0 + KT > kv_end;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = nt * 8 + 2 * t + (e & 1);
          const int col = k0 + cl;
          const int qp = e < 2 ? qpos_lo : qpos_hi;
          float x = s[nt * 4 + e] * scale_log2;
          if constexpr (QUANT) x *= ks_s[cl];  // k's per-position scale
          if (masked && (col >= kv_end || col > qp)) x = kNegInf;
          s[nt * 4 + e] = x;
        }

      // p in place as the register A operand of O += P V (k = kv position);
      // with int8, v's scale rides on P (f16) after l has summed the raw p.
      uint32_t pa[KT / 16][4];
      if constexpr (QUANT) {
        const float* vs_s = ks_s + KT;
        softmax_tile<KT, HALVES>(
            s, m_lo, m_hi, l_lo, l_hi, o, pa,
            [&](int nt, float p0, float p1, float p2, float p3, uint32_t& a,
                uint32_t& c) {
              const float v0 = vs_s[nt * 8 + 2 * t];
              const float v1 = vs_s[nt * 8 + 2 * t + 1];
              a = pack_f16(p0 * v0, p1 * v1);
              c = pack_f16(p2 * v0, p3 * v1);
            });
      } else {
        softmax_tile<KT, HALVES>(s, m_lo, m_hi, l_lo, l_hi, o, pa,
                                 PackBf16());
      }
      pv_tile<KT, HALVES, QUANT>(o, pa, v_addr, L::THALF);
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with it
    }

    const float inv_lo = 1.f / fmaxf(quad_sum(l_lo), 1e-30f);
    const float inv_hi = 1.f / fmaxf(quad_sum(l_hi), 1e-30f);
    // M row r is head r / tq, token q0 + r % tq; rows past G heads or past T
    // are not stored.
    const int head_lo = row_lo / tq, tok_lo = q0 + row_lo % tq;
    const int head_hi = row_hi / tq, tok_hi = q0 + row_hi % tq;
    const bool st_lo = head_lo < g && tok_lo < t_len;
    const bool st_hi = head_hi < g && tok_hi < t_len;
    const size_t base_lo =
        ((size_t)(b * hq + h * g + head_lo) * t_len + tok_lo) * D;
    const size_t base_hi =
        ((size_t)(b * hq + h * g + head_hi) * t_len + tok_hi) * D;
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        const int col = hh * 64 + dn * 8 + 2 * t;
        if (st_lo)
          *reinterpret_cast<__nv_bfloat162*>(out + base_lo + col) =
              __floats2bfloat162_rn(o[hh][dn * 4] * inv_lo,
                                    o[hh][dn * 4 + 1] * inv_lo);
        if (st_hi)
          *reinterpret_cast<__nv_bfloat162*>(out + base_hi + col) =
              __floats2bfloat162_rn(o[hh][dn * 4 + 2] * inv_hi,
                                    o[hh][dn * 4 + 3] * inv_hi);
      }
  }
}

template <int D, bool QUANT>
int prefill_launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* start, void* out, int b,
                   int hq, int hkv, int t_len, int pool_rows, int nbps,
                   int block_size, float scale, cudaStream_t st) {
  using L = PrefillSmem<D, QUANT>;
  auto kernel = paged_prefill_kernel<D, QUANT>;
  constexpr int smem = L::BYTES;
  // The runtime call first: it binds the context the encoder needs.
  if (int rc = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return rc;
  const int g = hq / hkv, tq = kRowsM / g;
  // Rows of one TMA box: the largest power of two dividing block_size, so
  // a box never crosses a pool block, at most one tile.
  const int box_rows = min(block_size & -block_size, L::KT);
  const cuuint64_t rows = static_cast<cuuint64_t>(hkv) * pool_rows;
  CUtensorMap qm, km, vm;
  {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(t_len),
                                static_cast<cuuint64_t>(b) * hq};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                   static_cast<cuuint64_t>(t_len) * D * 2};
    const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(tq),
                               static_cast<cuuint32_t>(g)};
    if (int rc = bf16_tensor_map(&qm, q, 3, dims, strides, box)) return rc;
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), rows};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) *
                                   (QUANT ? 1 : 2)};
    const cuuint32_t box[2] = {QUANT ? static_cast<cuuint32_t>(D) : 64u,
                               static_cast<cuuint32_t>(box_rows)};
    if constexpr (QUANT) {
      if (int rc = int8_tensor_map(&km, k_pool, 2, dims, strides, box))
        return rc;
      if (int rc = int8_tensor_map(&vm, v_pool, 2, dims, strides, box))
        return rc;
    } else {
      if (int rc = bf16_tensor_map(&km, k_pool, 2, dims, strides, box))
        return rc;
      if (int rc = bf16_tensor_map(&vm, v_pool, 2, dims, strides, box))
        return rc;
    }
  }
  const dim3 grid((t_len + tq - 1) / tq, hkv, b);
  kernel<<<grid, kWgThreads, smem, st>>>(
      qm, km, vm, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(start), static_cast<bf16*>(out), hq, hkv,
      t_len, pool_rows, nbps, block_size, box_rows, tq, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <bool QUANT>
int prefill_dispatch(const void* q, const void* k_pool, const void* v_pool,
                     const void* k_scale, const void* v_scale,
                     const void* tables, const void* start, void* out, int b,
                     int hq, int hkv, int t_len, int head_dim, int pool_rows,
                     int nbps, int block_size, float scale, void* stream) {
  if (b <= 0 || b > 65535 || hkv <= 0 || hkv > 65535 || hq % hkv != 0 ||
      hq / hkv > kRowsM || t_len <= 0 || pool_rows <= 0 || nbps <= 0 ||
      block_size <= 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return prefill_launch<64, QUANT>(q, k_pool, v_pool, k_scale, v_scale,
                                       tables, start, out, b, hq, hkv, t_len,
                                       pool_rows, nbps, block_size, scale,
                                       st);
    case 128:
      return prefill_launch<128, QUANT>(q, k_pool, v_pool, k_scale, v_scale,
                                        tables, start, out, b, hq, hkv, t_len,
                                        pool_rows, nbps, block_size, scale,
                                        st);
    default:
      return -2;
  }
}

}  // namespace

extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* valid_len, void* out, void* part_acc,
                            void* part_ml, int b, int hq, int hkv,
                            int head_dim, int pool_rows, int nbps,
                            int block_size, int splits, float scale,
                            void* stream) {
  return decode_dispatch<false>(q, k_pool, v_pool, nullptr, nullptr, tables,
                                valid_len, out, part_acc, part_ml, b, hq, hkv,
                                head_dim, pool_rows, nbps, block_size, splits,
                                scale, stream);
}

extern "C" int paged_prefill(const void* q, const void* k_pool,
                             const void* v_pool, const void* tables,
                             const void* start, void* out, int b, int hq,
                             int hkv, int t_len, int head_dim, int pool_rows,
                             int nbps, int block_size, float scale,
                             void* stream) {
  return prefill_dispatch<false>(q, k_pool, v_pool, nullptr, nullptr, tables,
                                 start, out, b, hq, hkv, t_len, head_dim,
                                 pool_rows, nbps, block_size, scale, stream);
}

extern "C" int paged_decode_int8(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* valid_len, void* out,
                                 void* part_acc, void* part_ml, int b,
                                 int hq, int hkv, int head_dim, int pool_rows,
                                 int nbps, int block_size, int splits,
                                 float scale, void* stream) {
  return decode_dispatch<true>(q, k_pool, v_pool, k_scale, v_scale, tables,
                               valid_len, out, part_acc, part_ml, b, hq, hkv,
                               head_dim, pool_rows, nbps, block_size, splits,
                               scale, stream);
}

extern "C" int paged_prefill_int8(const void* q, const void* k_pool,
                                  const void* v_pool, const void* k_scale,
                                  const void* v_scale, const void* tables,
                                  const void* start, void* out, int b,
                                  int hq, int hkv, int t_len, int head_dim,
                                  int pool_rows, int nbps, int block_size,
                                  float scale, void* stream) {
  return prefill_dispatch<true>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                start, out, b, hq, hkv, t_len, head_dim,
                                pool_rows, nbps, block_size, scale, stream);
}
