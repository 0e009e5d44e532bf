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
// head"), so one block serves the G query heads of one kv head.
//
// What bounds them on the H100. Decode reads K and V of every sequence's
// valid prefix once (sum(valid_len) * H_kv * D * 2 * 2 bytes) and does ~2
// operations per byte: bound by bytes. Prefill at a 128-token chunk does
// 4 * G * T operations per kv byte: bound by operations once the tensor
// cores do them. This first version uses CUDA-core FMAs (no wgmma, no TMA),
// so prefill runs well below its tensor-core bound and decode, with one
// block per (sequence, kv head) -- 64 blocks at batch 8 on 132 SMs -- below
// its memory bound: occupancy is the known weak point, and split-K over the
// kv axis is left to a later change.
//
// Design. One kernel body serves both: a block owns ROWS query rows (G
// heads x ROWS/G tokens) of one (sequence, kv head) and walks the kv axis
// in tiles of KT = 32 positions, reading each position's pool row through
// the block table itself (the scalar prefetch of the TPU kernel becomes a
// table load per staged row). K and V tiles are staged in shared memory,
// scores and the online softmax run in f32 in base 2, and each thread owns
// one output column for all ROWS rows, so the f32 accumulators stay in
// registers across the whole kv walk. Tiles past the block's last query
// position are never visited; the causal mask is applied only on tiles
// that straddle the first query's position. Query rows of padded tokens
// compute finite values like any other row (the caller discards them).
//
// The int8 branch (QUANT) is the same body. It reads each int8 K/V row
// (128 B at head_dim 128: half the bf16 branch's bytes) four values per
// thread and converts them exactly to bf16 in the same shared tiles, and
// stages the tile's k and v scales (8 B per position and head, read by 32
// threads on consecutive rows of each pool block). k's scale is constant
// over D, so it multiplies the finished score (as the TPU kernel does,
// after the softmax scale); v's scale varies over the PV contraction, so
// it multiplies each probability after the row sum l, and the
// probabilities stay f32 into PV in both branches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKvTile = 32;

template <int HEAD_DIM, int ROWS, bool DECODE, bool QUANT>
__global__ void __launch_bounds__(HEAD_DIM)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const void* __restrict__ k_pool,
                       const void* __restrict__ v_pool,
                       const float* __restrict__ k_scale,  // QUANT only
                       const float* __restrict__ v_scale,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ pos,
                       __nv_bfloat16* __restrict__ out, int hq, int hkv,
                       int t_len, int pool_rows, int nbps, int block_size,
                       float scale_log2) {
  constexpr int NWARPS = HEAD_DIM / 32;
  constexpr int RPW = ROWS / NWARPS;  // score rows per warp
  constexpr int QS = HEAD_DIM + 2;    // padded row: conflict-free column reads
  constexpr int HALF = HEAD_DIM / 2;
  static_assert(ROWS % NWARPS == 0, "rows must split evenly over warps");

  __shared__ __align__(16) __nv_bfloat16 q_s[ROWS][QS];
  __shared__ __align__(16) __nv_bfloat16 k_s[kKvTile][QS];
  __shared__ __align__(16) __nv_bfloat16 v_s[kKvTile][HEAD_DIM];
  __shared__ float s_s[ROWS][kKvTile + 1];
  __shared__ float m_s[ROWS], l_s[ROWS], c_s[ROWS];
  __shared__ float ks_s[kKvTile], vs_s[kKvTile];  // the int8 branch's

  const int b = blockIdx.x, h = blockIdx.y, tile = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = hq / hkv;
  const int tq = ROWS / g;  // query tokens per block
  const int rows = tq * g;
  const int first_i = tile * tq;
  const int n_tok = min(tq, t_len - first_i);
  const int span = nbps * block_size;
  const int start = DECODE ? pos[b] - 1 : pos[b];
  const int first_q = start + first_i;
  const int kv_end = min(first_q + n_tok, span);  // exclusive

  // Stage this block's query rows (row r = token r / g, head r % g).
  for (int w = tid; w < ROWS * HALF; w += HEAD_DIM) {
    const int r = w / HALF, c2 = w % HALF;
    __nv_bfloat162 val = __floats2bfloat162_rn(0.f, 0.f);
    if (r < rows && r / g < n_tok) {
      const int head = h * g + r % g;
      const size_t off =
          ((size_t)(b * hq + head) * t_len + first_i + r / g) * HEAD_DIM +
          2 * c2;
      val = *reinterpret_cast<const __nv_bfloat162*>(q + off);
    }
    *reinterpret_cast<__nv_bfloat162*>(&q_s[r][2 * c2]) = val;
  }
  if (tid < ROWS) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;

  const int32_t* table = tables + (size_t)b * nbps;
  for (int kt = 0; kt < kv_end; kt += kKvTile) {
    // Stage K and V for positions [kt, kt + KT); rows past kv_end are
    // zero-filled (their scores are masked, and 0 * garbage could be NaN).
    if constexpr (QUANT) {
      constexpr int QUART = HEAD_DIM / 4;  // four int8 values a thread
      const int8_t* k8 = static_cast<const int8_t*>(k_pool);
      const int8_t* v8 = static_cast<const int8_t*>(v_pool);
      for (int w = tid; w < kKvTile * QUART; w += HEAD_DIM) {
        const int r = w / QUART, c4 = w % QUART;
        const int kp = kt + r;
        char4 kc = make_char4(0, 0, 0, 0), vc = kc;
        if (kp < kv_end) {
          const size_t row =
              (size_t)table[kp / block_size] * block_size + kp % block_size;
          const size_t off =
              ((size_t)h * pool_rows + row) * HEAD_DIM + 4 * c4;
          kc = *reinterpret_cast<const char4*>(k8 + off);
          vc = *reinterpret_cast<const char4*>(v8 + off);
        }
        // int8 -> bf16 is exact.
        __nv_bfloat162* kd =
            reinterpret_cast<__nv_bfloat162*>(&k_s[r][4 * c4]);
        __nv_bfloat162* vd =
            reinterpret_cast<__nv_bfloat162*>(&v_s[r][4 * c4]);
        kd[0] = __floats2bfloat162_rn(kc.x, kc.y);
        kd[1] = __floats2bfloat162_rn(kc.z, kc.w);
        vd[0] = __floats2bfloat162_rn(vc.x, vc.y);
        vd[1] = __floats2bfloat162_rn(vc.z, vc.w);
      }
      if (tid < kKvTile) {
        const int kp = kt + tid;
        float ks = 0.f, vs = 0.f;
        if (kp < kv_end) {
          const size_t row =
              (size_t)table[kp / block_size] * block_size + kp % block_size;
          ks = k_scale[(size_t)h * pool_rows + row];
          vs = v_scale[(size_t)h * pool_rows + row];
        }
        ks_s[tid] = ks;
        vs_s[tid] = vs;
      }
    } else {
      const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k_pool);
      const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v_pool);
      for (int w = tid; w < kKvTile * HALF; w += HEAD_DIM) {
        const int r = w / HALF, c2 = w % HALF;
        const int kp = kt + r;
        __nv_bfloat162 kv = __floats2bfloat162_rn(0.f, 0.f), vv = kv;
        if (kp < kv_end) {
          const size_t row =
              (size_t)table[kp / block_size] * block_size + kp % block_size;
          const size_t off =
              ((size_t)h * pool_rows + row) * HEAD_DIM + 2 * c2;
          kv = *reinterpret_cast<const __nv_bfloat162*>(kb + off);
          vv = *reinterpret_cast<const __nv_bfloat162*>(vb + off);
        }
        *reinterpret_cast<__nv_bfloat162*>(&k_s[r][2 * c2]) = kv;
        *reinterpret_cast<__nv_bfloat162*>(&v_s[r][2 * c2]) = vv;
      }
    }
    __syncthreads();

    // Scores: lane = kv position in the tile, warp w takes rows w + NWARPS*i.
    float sc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i] = 0.f;
#pragma unroll 4
    for (int d2 = 0; d2 < HALF; ++d2) {
      const float2 kf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&k_s[lane][2 * d2]));
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float2 qf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                &q_s[warp + NWARPS * i][2 * d2]));
        sc[i] = fmaf(qf.x, kf.x, fmaf(qf.y, kf.y, sc[i]));
      }
    }
    const bool straddle = kt + kKvTile - 1 > first_q;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NWARPS * i;
      float s = sc[i] * scale_log2;
      if (QUANT) s *= ks_s[lane];  // k's per-position scale, exact
      if (straddle) {
        const int kp = kt + lane;
        const int qpos = first_q + r / g;
        if (kp >= kv_end || kp > qpos) s = kNegInf;
      }
      s_s[r][lane] = s;
    }
    __syncthreads();

    // Online softmax, one thread per row.
    if (tid < ROWS) {
      const float m_prev = m_s[tid];
      float mx = m_prev;
      for (int c = 0; c < kKvTile; ++c) mx = fmaxf(mx, s_s[tid][c]);
      const float corr = exp2f(m_prev - mx);
      float sum = 0.f;
      for (int c = 0; c < kKvTile; ++c) {
        const float p = exp2f(s_s[tid][c] - mx);
        // l sums the softmax's own p; v's scale folds into PV's weights.
        s_s[tid][c] = QUANT ? p * vs_s[c] : p;
        sum += p;
      }
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = mx;
      c_s[tid] = corr;
    }
    __syncthreads();

    // P @ V: thread tid owns output column tid for every row.
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] *= c_s[r];
#pragma unroll 2
    for (int c = 0; c < kKvTile; ++c) {
      const float vf = __bfloat162float(v_s[c][tid]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(s_s[r][c], vf, acc[r]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < rows && r / g < n_tok) {
      const int head = h * g + r % g;
      const size_t off =
          ((size_t)(b * hq + head) * t_len + first_i + r / g) * HEAD_DIM + tid;
      out[off] = __float2bfloat16(acc[r] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <int HEAD_DIM, int ROWS, bool DECODE, bool QUANT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* pos, void* out, int b, int hq, int hkv, int t_len,
           int pool_rows, int nbps, int block_size, float scale,
           void* stream) {
  const int tq = ROWS / (hq / hkv);
  const dim3 grid(b, hkv, (t_len + tq - 1) / tq);
  paged_attention_kernel<HEAD_DIM, ROWS, DECODE, QUANT>
      <<<grid, HEAD_DIM, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
          static_cast<const float*>(k_scale),
          static_cast<const float*>(v_scale),
          static_cast<const int32_t*>(tables),
          static_cast<const int32_t*>(pos),
          static_cast<__nv_bfloat16*>(out), hq, hkv, t_len, pool_rows, nbps,
          block_size, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kDecodeRows = 8;    // G <= 8 query heads per kv head
constexpr int kPrefillRows = 64;  // G heads x 64/G tokens per block

bool shapes_ok(int b, int hq, int hkv, int t_len, int pool_rows, int nbps,
               int block_size, int max_g) {
  return b > 0 && hkv > 0 && hq % hkv == 0 && hq / hkv <= max_g &&
         t_len > 0 && pool_rows > 0 && nbps > 0 && block_size > 0;
}

template <bool DECODE, bool QUANT>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* tables,
             const void* pos, void* out, int b, int hq, int hkv, int t_len,
             int head_dim, int pool_rows, int nbps, int block_size,
             float scale, void* stream) {
  constexpr int ROWS = DECODE ? kDecodeRows : kPrefillRows;
  if (!shapes_ok(b, hq, hkv, t_len, pool_rows, nbps, block_size, ROWS))
    return -1;
  switch (head_dim) {
    case 64:
      return launch<64, ROWS, DECODE, QUANT>(
          q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, b, hq, hkv,
          t_len, pool_rows, nbps, block_size, scale, stream);
    case 128:
      return launch<128, ROWS, DECODE, QUANT>(
          q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, b, hq, hkv,
          t_len, pool_rows, nbps, block_size, scale, stream);
    default:
      return -2;
  }
}

}  // namespace

extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* valid_len, void* out, int b, int hq,
                            int hkv, int head_dim, int pool_rows, int nbps,
                            int block_size, float scale, void* stream) {
  return dispatch<true, false>(q, k_pool, v_pool, nullptr, nullptr, tables,
                               valid_len, out, b, hq, hkv, 1, head_dim,
                               pool_rows, nbps, block_size, scale, stream);
}

extern "C" int paged_prefill(const void* q, const void* k_pool,
                             const void* v_pool, const void* tables,
                             const void* start, void* out, int b, int hq,
                             int hkv, int t_len, int head_dim, int pool_rows,
                             int nbps, int block_size, float scale,
                             void* stream) {
  return dispatch<false, false>(q, k_pool, v_pool, nullptr, nullptr, tables,
                                start, out, b, hq, hkv, t_len, head_dim,
                                pool_rows, nbps, block_size, scale, stream);
}

extern "C" int paged_decode_int8(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* valid_len, void* out, int b,
                                 int hq, int hkv, int head_dim, int pool_rows,
                                 int nbps, int block_size, float scale,
                                 void* stream) {
  return dispatch<true, true>(q, k_pool, v_pool, k_scale, v_scale, tables,
                              valid_len, out, b, hq, hkv, 1, head_dim,
                              pool_rows, nbps, block_size, scale, stream);
}

extern "C" int paged_prefill_int8(const void* q, const void* k_pool,
                                  const void* v_pool, const void* k_scale,
                                  const void* v_scale, const void* tables,
                                  const void* start, void* out, int b,
                                  int hq, int hkv, int t_len, int head_dim,
                                  int pool_rows, int nbps, int block_size,
                                  float scale, void* stream) {
  return dispatch<false, true>(q, k_pool, v_pool, k_scale, v_scale, tables,
                               start, out, b, hq, hkv, t_len, head_dim,
                               pool_rows, nbps, block_size, scale, stream);
}
