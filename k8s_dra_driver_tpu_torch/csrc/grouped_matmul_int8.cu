// The int8 grouped matrix product for Hopper (sm_90a): the primitive MoE
// path's expert products with int8 weights (models/moe.py
// _dropless_tp_out, on a mesh without an expert axis, through
// ops/moe_dispatch.py::grouped_matmul_int8).
//
// Replaces no Pallas kernel: the reference runs XLA's lax.ragged_dot with
// the int8 rhs kept int8 and the per-channel scale in the epilogue
// (k8s_dra_driver_tpu/ops/moe_dispatch.py::grouped_matmul, its int8
// branch). Computes, with g(r) the group whose rows [start_g, start_g +
// size_g) hold row r:
//
//   out[r, c] = bf16( (sum_k lhs[r, k] * q[g(r), k, c]) * scale[g(r), c] )
//
// with f32 sums; rows at or past sum(group_sizes) are 0. lhs bf16 [rows,
// K] row-major; q int8 and scale f32 addressed through strides, so a
// tensor shard's block of a whole expert stack is read where it lies:
// column c of the output is column c % half_n of half c / half_n (a
// gate/up stack [E, K, 2, M / T] gives the gate half first, half_n = M /
// T; a plain [E, K, N] stack has one half, half_n = N).
//
// What bounds it on the H100: bytes at decode (the touched experts' int8
// weights, ~29 MB an expert for Mixtral's gate/up at tensor 4, against a
// few dozen rows), operations at prefill (2 x rows x K x N). This first
// design is simple: a block owns 64 rows of one group and 64 output
// columns and walks K in 128-deep steps (32 where K is no multiple of
// 128); its 4 warps hold the step's weights in registers (16 int8 a load,
// four a thread), store the lhs tile's rows of the group (16-byte loads)
// and the weights converted to bf16 in shared memory (int8
// values are exact in bf16), issue the next step's weight loads, then run
// wmma m16n16k16 products with f32 accumulators (each warp a 32 x 32
// quarter; a warp whose rows all lie past the group skips them), so the
// next step's weights stream in during the products; the epilogue stages
// the sums in shared memory, multiplies each column's scale and writes 16
// bytes a thread. Each weight byte of a group is read once per 64 of its
// rows, so at decode (a group of 2-16 rows) every touched expert's weights
// are read exactly once. No TMA ring, no wgmma: making it fast is later
// work.
//
// Blocks: x over the column tiles, y over work items: a group's 64-row
// tiles in order, then the tiles of the rows past the last group (written
// as zeros), then idle items (the grid is sized by rows / 64 + groups + 1,
// an upper bound: a block finds its item by walking the group sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kRows = 64;     // output rows a block
constexpr int kCols = 64;     // output columns a block
constexpr int kThreads = 128;
constexpr int kBPitch = kCols + 8;    // bf16; rows 144 bytes apart
constexpr int kCPitch = kCols + 4;    // f32

struct Layout {
  long long q_se, q_sk, q_sh;  // q strides: expert, row (k), half
  long long s_se, s_sh;        // scale strides: expert, half
  int half_n;                  // columns a half
};

// Shared memory of a block walking K in DEPTH-deep steps: the lhs tile
// (64 x DEPTH bf16) and the weight tile (DEPTH x 64, converted to bf16);
// the epilogue's f32 tile reuses them.
template <int DEPTH>
struct Smem {
  static constexpr int A_PITCH = DEPTH + 8;  // bf16; rows 16-byte aligned
  static constexpr int A = kRows * A_PITCH * 2;
  static constexpr int B = DEPTH * kBPitch * 2;
  static constexpr int C = kRows * kCPitch * 4;
  static constexpr int BYTES = (A + B > C ? A + B : C);
};

template <int DEPTH>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_int8_kernel(const bf16* __restrict__ lhs,
                           const int8_t* __restrict__ q,
                           const float* __restrict__ scale,
                           const int32_t* __restrict__ sizes,
                           bf16* __restrict__ out, int rows, int k, int n,
                           int n_groups, Layout lay) {
  using S = Smem<DEPTH>;
  __shared__ __align__(128) unsigned char smem[S::BYTES];
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = reinterpret_cast<bf16*>(smem + S::A);
  float* c_s = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kCols;

  // The work item: (group, first row, rows) or a tail of zero rows.
  int item = blockIdx.y;
  int start = 0, group = -1, row0 = 0, nrows = 0;
  for (int e = 0; e < n_groups; ++e) {
    const int end = min(start + max(sizes[e], 0), rows);
    const int tiles = (end - start + kRows - 1) / kRows;
    if (item < tiles) {
      group = e;
      row0 = start + item * kRows;
      nrows = min(kRows, end - row0);
      break;
    }
    item -= tiles;
    start = end;
  }
  if (group < 0) {
    // Rows past the last group: zeros.
    row0 = start + item * kRows;
    if (row0 >= rows) return;
    nrows = min(kRows, rows - row0);
    for (int c = tid; c < nrows * (kCols / 8); c += kThreads) {
      const int r = c / (kCols / 8), cc = (c % (kCols / 8)) * 8;
      *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * n + col0 + cc) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const int half = col0 / lay.half_n;
  const int hc0 = col0 - half * lay.half_n;  // the tile's first column in
                                             // its half
  const int8_t* qg = q + group * lay.q_se + half * lay.q_sh + hc0;
  const bf16* ag = lhs + (long long)row0 * k;

  const int warp = tid / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // 16-byte chunks a step: the lhs tile's rows hold DEPTH / 8 of them,
  // the weight tile's DEPTH rows 4 each.
  constexpr int A_CHUNKS = kRows * DEPTH / 8;
  constexpr int B_CHUNKS = DEPTH * kCols / 16;
  constexpr int B_LOADS = B_CHUNKS / kThreads;
  // The weight loads of step k0 + DEPTH are issued before step k0's
  // products, so they stay in flight through the products and barriers.
  int4 raw[B_LOADS];
  auto load_weights = [&](int k0) {
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / 4, part = (c % 4) * 16;
      raw[i] = __ldg(reinterpret_cast<const int4*>(
          qg + (long long)(k0 + r) * lay.q_sk + part));
    }
  };
  // A warp whose 32 rows all lie past the group's skips the products
  // (at decode a group holds 2-16 rows).
  const bool live = wr < nrows;
  load_weights(0);
  for (int k0 = 0; k0 < k; k0 += DEPTH) {
    // Rows past the group are neither loaded nor stored: a product's row
    // reads only its own lhs row, and those rows' outputs are not written.
#pragma unroll
    for (int i = 0; i < A_CHUNKS / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (DEPTH / 8), part = (c % (DEPTH / 8)) * 8;
      if (r < nrows)
        *reinterpret_cast<uint4*>(a_s + r * S::A_PITCH + part) =
            *reinterpret_cast<const uint4*>(ag + (long long)r * k + k0 +
                                            part);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / 4, part = (c % 4) * 16;
      const int8_t* b8 = reinterpret_cast<const int8_t*>(&raw[i]);
      __align__(16) bf16 conv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        conv[j] = __float2bfloat16(static_cast<float>(b8[j]));
      uint4* dst = reinterpret_cast<uint4*>(b_s + r * kBPitch + part);
      dst[0] = reinterpret_cast<const uint4*>(conv)[0];
      dst[1] = reinterpret_cast<const uint4*>(conv)[1];
    }
    if (k0 + DEPTH < k) load_weights(k0 + DEPTH);
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < DEPTH; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], a_s + (wr + i * 16) * S::A_PITCH + kk,
                                 S::A_PITCH);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], b_s + kk * kBPitch + wc + j * 16,
                                 kBPitch);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_s + (wr + i * 16) * kCPitch + wc + j * 16,
                              acc[i][j], kCPitch, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: each column's scale, one cast, 8 columns (16 bytes) a store.
  const float* sg = scale + group * lay.s_se + half * lay.s_sh + hc0;
  for (int c = tid; c < nrows * (kCols / 8); c += kThreads) {
    const int r = c / (kCols / 8), cc = (c % (kCols / 8)) * 8;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = __float2bfloat16(c_s[r * kCPitch + cc + j] * sg[cc + j]);
    *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * n + col0 + cc) =
        *reinterpret_cast<const uint4*>(v);
  }
}

template <int DEPTH>
int launch(const void* lhs, const void* q, const void* scale,
           const void* sizes, void* out, int rows, int k, int n,
           int n_groups, const Layout& lay, long long items,
           cudaStream_t st) {
  const dim3 grid(n / kCols, static_cast<unsigned>(items));
  grouped_matmul_int8_kernel<DEPTH><<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(lhs), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<const int32_t*>(sizes),
      static_cast<bf16*>(out), rows, k, n, n_groups, lay);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out bf16 [rows, n] = the grouped product of lhs bf16 [rows, k] with the
// int8 stack q (strides q_se, q_sk, q_sh in bytes: expert, row, half) and
// the f32 scales (strides s_se, s_sh in elements), n = half_n or 2 half_n.
// k in steps of 32, half_n of 64; strides of q multiples of 16 bytes.
extern "C" int grouped_matmul_int8(const void* lhs, const void* q,
                                   const void* scale, const void* group_sizes,
                                   void* out, int rows, int k, int n,
                                   int n_groups, int half_n, long long q_se,
                                   long long q_sk, long long q_sh,
                                   long long s_se, long long s_sh,
                                   void* stream) {
  if (rows < 0 || k <= 0 || k % 32 || half_n <= 0 || half_n % kCols ||
      (n != half_n && n != 2 * half_n) || n_groups <= 0 || q_se % 16 ||
      q_sk % 16 || q_sh % 16)
    return -1;
  if (rows == 0) return 0;
  const long long items = (rows + kRows - 1) / kRows + n_groups + 1;
  if (items > 65535) return -1;
  const Layout lay{q_se, q_sk, q_sh, s_se, s_sh, half_n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k % 128 == 0)
    return launch<128>(lhs, q, scale, group_sizes, out, rows, k, n, n_groups,
                       lay, items, st);
  return launch<32>(lhs, q, scale, group_sizes, out, rows, k, n, n_groups,
                    lay, items, st);
}
