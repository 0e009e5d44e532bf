// RMSNorm for Hopper (sm_90a): the forward and its gradient.
//
// Replaces:
//   rmsnorm_forward  <- k8s_dra_driver_tpu/ops/norms.py::_rmsnorm_kernel
//                       (the Pallas kernel of _rmsnorm_pallas)
//   rmsnorm_backward <- ::_rmsnorm_diff_bwd, jax.vjp of rmsnorm_reference,
//                       which XLA compiles into fused loops (no Pallas
//                       kernel); here one kernel plus an ordered reduction
//                       of the weight's gradient.
//
// Computes, per row of x [rows, D] (bf16, f16 or f32; the weight w [D] in
// any of the three, its dtype a runtime code), all in f32:
//   forward:  r = rsqrt(mean(x^2) + eps), y = cast(x r w)      (x's dtype)
//   backward: xn = x r, dx = cast(r (g w - xn mean(g w xn)))  (x's dtype),
//             dw = cast(sum over rows of g xn)                (w's dtype)
// The forward's arithmetic is rmsnorm_reference's: the f32 mean square,
// rsqrt(var + eps), (x r) w, one cast back.
//
// What bounds it on the H100: bytes. A few operations per element against
// 2 * itemsize bytes moved (the forward reads x, writes y; the gradient
// reads x and g, writes dx): far below the ~295 bf16 operations a byte
// where the tensor cores would become the limit. A row of Llama-3-8B is 8
// KB in bf16; the paths launch it at 1 row (a B 1 draft), 5 (a verify
// window), 8 (decode), 512 (a packed prefill) and 8192-16384 rows
// (training). At few rows the bound is well under a microsecond and the
// launch and one row's load, reduction and store latency set the time; at
// many rows the card must keep enough bytes in flight.
//
// Every thread works on slots: 8 columns, one 16-byte word of bf16 or f16
// (two of f32), loaded and stored whole where the row's width and the
// pointers allow (`vec`), else element by element (a tail narrower than
// one word, or an unaligned width).
//
// Forward (rmsnorm_fwd), one slot a thread, sized by ops/norms.py::plan
// from the row's width: one CTA a row up to width 8192 (512 threads at
// 4096), a plain launch; a wider row takes a thread-block cluster of 2, 4
// or 8 CTAs. Each thread loads its x slot and its w slot together before
// any reduction; the warps' partial sums of squares meet at one barrier
// (the block's, or the cluster's, each warp pushing its sum into every
// CTA's shared memory through distributed shared memory; a CTA may write
// into a peer only once the peer runs, which an arrive on the cluster
// barrier at the top says), and each warp then sums the partials in the
// same order. Measured on the H100 (PERF.md; tools/k1_int8_bench.py
// --explore), one CTA a row beat the two forms first written for the
// paths' widths: a cluster of up to 8 CTAs a row at few rows (2.5-2.9 us a
// launch among 50 in a CUDA graph against 1.7-2.0 at 1, 5 and 8 rows: the
// cluster's launch and barrier cost more than spreading 8 KB over more
// SMs gains), and a warp a row with the weight in shared memory at many
// (0.0112 against 0.0089 ms at 512 rows, equal at 16384: a lane's 128
// columns make long chains).
//
// Gradient (rmsnorm_bwd + rmsnorm_dw_reduce): a CTA of up to 8 warps owns
// a row at a time, each thread S slots of it, with its slots of w in
// registers and its slots of dw accumulated in registers over the CTA's
// rows. Per row the two sums (x^2 and g w x) are reduced together: warp
// shuffles, then one block barrier (the warps' partials double-buffered by
// row parity, so a second barrier is not needed). The next row's x and g
// are loaded before that barrier. The CTA writes its dw partial row to a
// scratch [blocks, D] in f32; rmsnorm_dw_reduce sums the partials in a
// fixed order (warp w takes blocks w, w + 8, ..., then the 8 warp sums in
// order) and casts. No atomics anywhere: two calls give the same bits.
//
// Every launch is capturable in a CUDA graph: no host sync, no allocation
// (ops/norms.py allocates the outputs and the scratch).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kSlot = 8;        // columns of a slot
constexpr int kBwdThreads = 256;
constexpr int kMaxCluster = 8;

// Dtype codes (ops/norms.py::_DTYPE_CODE).
constexpr int kBf16 = 0, kF16 = 1, kF32 = 2;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// One slot's raw bits: 8 elements of T in sizeof(T) / 2 words.
template <typename T>
struct Slot {
  uint4 w[sizeof(T) / 2];
};

__device__ __forceinline__ float2 unpack2(uint32_t u, bf16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ float2 unpack2(uint32_t u, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}
__device__ __forceinline__ uint32_t pack2(float a, float b, bf16) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half) {
  const __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ void to_floats(const Slot<T>& s, float (&f)[8]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      f[4 * j] = __uint_as_float(s.w[j].x);
      f[4 * j + 1] = __uint_as_float(s.w[j].y);
      f[4 * j + 2] = __uint_as_float(s.w[j].z);
      f[4 * j + 3] = __uint_as_float(s.w[j].w);
    }
  } else {
    const uint32_t u[4] = {s.w[0].x, s.w[0].y, s.w[0].z, s.w[0].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = unpack2(u[j], T());
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ void from_floats(Slot<T>& s, const float (&f)[8]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      s.w[j] = make_uint4(__float_as_uint(f[4 * j]),
                          __float_as_uint(f[4 * j + 1]),
                          __float_as_uint(f[4 * j + 2]),
                          __float_as_uint(f[4 * j + 3]));
  } else {
    s.w[0] = make_uint4(pack2(f[0], f[1], T()), pack2(f[2], f[3], T()),
                        pack2(f[4], f[5], T()), pack2(f[6], f[7], T()));
  }
}

// The slot at column c of a row: whole words where `vec`, else element by
// element, zeros past d.
template <typename T>
__device__ __forceinline__ void load_slot(Slot<T>& s, const T* row, int c,
                                          int d, bool vec) {
  if (vec && c + kSlot <= d) {
    const uint4* p = reinterpret_cast<const uint4*>(row + c);
#pragma unroll
    for (int j = 0; j < (int)(sizeof(T) / 2); ++j) s.w[j] = p[j];
  } else {
    float f[8];
#pragma unroll
    for (int i = 0; i < kSlot; ++i) f[i] = c + i < d ? to_f(row[c + i]) : 0.f;
    from_floats(s, f);
  }
}

// y's slot at column c, rounded to T (round to nearest even, as a cast).
template <typename T>
__device__ __forceinline__ void store_slot(T* row, int c, int d, bool vec,
                                           const float (&f)[8]) {
  if (vec && c + kSlot <= d) {
    Slot<T> s;
    from_floats(s, f);
    uint4* p = reinterpret_cast<uint4*>(row + c);
#pragma unroll
    for (int j = 0; j < (int)(sizeof(T) / 2); ++j) p[j] = s.w[j];
  } else {
#pragma unroll
    for (int i = 0; i < kSlot; ++i)
      if (c + i < d) row[c + i] = from_f<T>(f[i]);
  }
}

// The weight's slot at column c as f32, its dtype a runtime code.
__device__ __forceinline__ void load_w(const void* w, int wdt, int c, int d,
                                       bool vec, float (&f)[8]) {
  if (wdt == kBf16) {
    Slot<bf16> s;
    load_slot(s, static_cast<const bf16*>(w), c, d, vec);
    to_floats(s, f);
  } else if (wdt == kF16) {
    Slot<__half> s;
    load_slot(s, static_cast<const __half*>(w), c, d, vec);
    to_floats(s, f);
  } else {
    Slot<float> s;
    load_slot(s, static_cast<const float*>(w), c, d, vec);
    to_floats(s, f);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Thread-block clusters: the barrier and distributed shared memory.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Arrives on the cluster barrier without ordering memory (the start-up
// phase: this CTA runs).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// Arrives with release semantics: this thread's writes, remote ones
// included, are visible to every thread that then waits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// v into the same shared-memory word of the cluster's CTA `rank`.
__device__ __forceinline__ void store_remote(float* local, uint32_t rank,
                                             float v) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

// ---------------------------------------------------------------------------
// The forward.
// ---------------------------------------------------------------------------

// CTA blockIdx.x of a cluster of C (CLUSTER; else C is 1 and the launch
// plain) owns columns [rank chunk, (rank + 1) chunk) of row blockIdx.x /
// C, thread t the slot at column rank chunk + 8 t. The x and w slots are
// loaded before any reduction. The warps' partial sums of squares meet at
// one barrier: the block's, or the cluster's through distributed shared
// memory, where each warp pushes its sum into every CTA of the cluster.
// Then each warp sums all the partials (a lane each, a warp shuffle), in
// the same order in every warp and CTA.
template <typename T, bool CLUSTER>
__global__ void __launch_bounds__(1024)
rmsnorm_fwd(const T* __restrict__ x, const void* __restrict__ w, int wdt,
            T* __restrict__ y, int d, int chunk, float eps, int vec) {
  __shared__ float part[kMaxCluster * 32];  // [rank][warp] partial sums
  if (CLUSTER) cluster_arrive_relaxed();
  const uint32_t rank = CLUSTER ? cluster_rank() : 0;
  const uint32_t csize = CLUSTER ? cluster_size() : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const size_t row = blockIdx.x / csize;
  const int c = rank * chunk + threadIdx.x * kSlot;
  const bool mine = threadIdx.x * kSlot < chunk && c < d;
  Slot<T> xs;
  float wf[8], f[8];
  float ss = 0.f;
  if (mine) {
    load_slot(xs, x + row * d, c, d, vec);
    load_w(w, wdt, c, d, vec, wf);
    to_floats(xs, f);
#pragma unroll
    for (int i = 0; i < kSlot; ++i) ss += f[i] * f[i];
  }
  ss = warp_sum(ss);
  if (CLUSTER) {
    cluster_wait();  // every CTA of the cluster runs: its memory is there
    if (lane == 0)
      for (uint32_t p = 0; p < csize; ++p)
        store_remote(&part[rank * nw + warp], p, ss);
    cluster_arrive();
    cluster_wait();  // every partial is in every CTA
  } else {
    if (lane == 0) part[warp] = ss;
    __syncthreads();
  }
  float total = 0.f;
  for (int i = lane; i < (int)csize * nw; i += 32) total += part[i];
  const float r = rsqrtf(warp_sum(total) / d + eps);
  if (mine) {
    float o[8];
#pragma unroll
    for (int i = 0; i < kSlot; ++i) o[i] = f[i] * r * wf[i];
    store_slot(y + row * d, c, d, vec, o);
  }
}

// ---------------------------------------------------------------------------
// The gradient.
// ---------------------------------------------------------------------------

// CTA blockIdx.x owns rows blockIdx.x, + gridDim.x, ...; thread t the slots
// t, t + blockDim.x, ... (S of them). dw_part: [gridDim.x, d] f32.
template <typename T, int S>
__global__ void __launch_bounds__(kBwdThreads, S <= 2 ? 2 : 1)
rmsnorm_bwd(const T* __restrict__ x, const T* __restrict__ g,
            const void* __restrict__ w, int wdt, T* __restrict__ dx,
            float* __restrict__ dw_part, int rows, int d, float eps,
            int vec) {
  __shared__ float2 red[2][kBwdThreads / 32];  // by row parity
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;

  float wf[S][8], dwa[S][8];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int c = (s * blockDim.x + threadIdx.x) * kSlot;
    if (c < d) {
      load_w(w, wdt, c, d, vec, wf[s]);
    } else {
#pragma unroll
      for (int i = 0; i < kSlot; ++i) wf[s][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kSlot; ++i) dwa[s][i] = 0.f;
  }

  Slot<T> xc[S], gc[S], xn[S], gn[S];
  auto load_row = [&](Slot<T> (&xb)[S], Slot<T> (&gb)[S], int row) {
    const T* px = x + (size_t)row * d;
    const T* pg = g + (size_t)row * d;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c = (s * blockDim.x + threadIdx.x) * kSlot;
      if (c < d) {
        load_slot(xb[s], px, c, d, vec);
        load_slot(gb[s], pg, c, d, vec);
      }
    }
  };

  int r = blockIdx.x;
  if (r < rows) load_row(xc, gc, r);
  for (int parity = 0; r < rows; r += gridDim.x, parity ^= 1) {
    const int rn = r + gridDim.x;
    if (rn < rows) load_row(xn, gn, rn);
    float ss = 0.f, sgwx = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c = (s * blockDim.x + threadIdx.x) * kSlot;
      if (c < d) {
        float xv[8], gv[8];
        to_floats(xc[s], xv);
        to_floats(gc[s], gv);
#pragma unroll
        for (int i = 0; i < kSlot; ++i) {
          ss += xv[i] * xv[i];
          sgwx += gv[i] * wf[s][i] * xv[i];
        }
      }
    }
    ss = warp_sum(ss);
    sgwx = warp_sum(sgwx);
    if (lane == 0) red[parity][warp] = make_float2(ss, sgwx);
    __syncthreads();
    float tss = 0.f, tg = 0.f;
    for (int i = 0; i < nw; ++i) {
      const float2 p = red[parity][i];
      tss += p.x;
      tg += p.y;
    }
    const float rr = rsqrtf(tss / d + eps);
    const float mean_gwxn = rr * tg / d;  // mean(g w xn)
    T* out = dx + (size_t)r * d;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c = (s * blockDim.x + threadIdx.x) * kSlot;
      if (c < d) {
        float xv[8], gv[8], o[8];
        to_floats(xc[s], xv);
        to_floats(gc[s], gv);
#pragma unroll
        for (int i = 0; i < kSlot; ++i) {
          const float xnv = xv[i] * rr;
          o[i] = rr * (gv[i] * wf[s][i] - xnv * mean_gwxn);
          dwa[s][i] += gv[i] * xnv;
        }
        store_slot(out, c, d, vec, o);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      xc[s] = xn[s];
      gc[s] = gn[s];
    }
  }

  float* part = dw_part + (size_t)blockIdx.x * d;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int c = (s * blockDim.x + threadIdx.x) * kSlot;
    if (c < d) store_slot(part, c, d, vec, dwa[s]);
  }
}

__device__ __forceinline__ void store_w(void* w, int wdt, int c, float v) {
  if (wdt == kBf16)
    static_cast<bf16*>(w)[c] = __float2bfloat16_rn(v);
  else if (wdt == kF16)
    static_cast<__half*>(w)[c] = __float2half_rn(v);
  else
    static_cast<float*>(w)[c] = v;
}

// dw[c] = cast(the sum over b of part[b, c]), in a fixed order: warp w
// sums b = w, w + 8, ... in order, then the 8 warp sums in order. A CTA
// owns 32 columns.
__global__ void __launch_bounds__(256)
rmsnorm_dw_reduce(const float* __restrict__ part, void* __restrict__ dw,
                  int wdt, int blocks, int d) {
  __shared__ float acc[8][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d)
    for (int b = warp; b < blocks; b += 8) s += part[(size_t)b * d + c];
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += acc[i][lane];
    store_w(dw, wdt, c, t);
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

template <typename T>
int forward(const void* x, const void* w, int wdt, void* y, int rows, int d,
            float eps, int cluster, int threads, int vec, cudaStream_t st) {
  const int slots = (d + kSlot - 1) / kSlot;
  const int chunk = (slots + cluster - 1) / cluster * kSlot;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      threads % 32 || threads > 1024 || threads * kSlot < chunk ||
      (long long)rows * cluster > 0x7fffffffLL)
    return -1;
  if (cluster == 1) {
    rmsnorm_fwd<T, false><<<rows, threads, 0, st>>>(
        static_cast<const T*>(x), w, wdt, static_cast<T*>(y), d, chunk, eps,
        vec);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (int rc = static_cast<int>(cudaLaunchKernelEx(
          &cfg, rmsnorm_fwd<T, true>, static_cast<const T*>(x), w, wdt,
          static_cast<T*>(y), d, chunk, eps, vec)))
    return rc;
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int launch_bwd(const void* x, const void* g, const void* w, int wdt, void* dx,
               void* part, int rows, int d, float eps, int threads, int grid,
               int vec, cudaStream_t st) {
  rmsnorm_bwd<T, S><<<grid, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), w, wdt,
      static_cast<T*>(dx), static_cast<float*>(part), rows, d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* x, const void* g, const void* w, int wdt, void* dx,
             void* dw, void* part, int rows, int d, float eps, int threads,
             int slots, int grid, int vec, cudaStream_t st) {
  if (threads % 32 || threads > kBwdThreads || grid <= 0 || grid > rows ||
      d > slots * threads * kSlot || part == nullptr)
    return -1;
  int rc = -1;
  switch (slots) {
    case 1:
      rc = launch_bwd<T, 1>(x, g, w, wdt, dx, part, rows, d, eps, threads,
                            grid, vec, st);
      break;
    case 2:
      rc = launch_bwd<T, 2>(x, g, w, wdt, dx, part, rows, d, eps, threads,
                            grid, vec, st);
      break;
    case 4:
      rc = launch_bwd<T, 4>(x, g, w, wdt, dx, part, rows, d, eps, threads,
                            grid, vec, st);
      break;
  }
  if (rc) return rc;
  rmsnorm_dw_reduce<<<(d + 31) / 32, 256, 0, st>>>(
      static_cast<const float*>(part), dw, wdt, grid, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, d] of dtype code xdt, w [d] of code wdt -> y [rows, d] (xdt).
// cluster 1: one CTA a row, a plain launch; else a cluster of that many
// CTAs a row; `threads` a CTA, one 8-column slot each. vec: every pointer
// is 16-byte aligned and d a multiple of 8. Returns -1 for what it
// refuses.
extern "C" int rmsnorm_forward(const void* x, const void* w, void* y,
                               int rows, int d, int xdt, int wdt, float eps,
                               int cluster, int threads, int vec,
                               void* stream) {
  if (rows <= 0 || d <= 0 || xdt < 0 || xdt > 2 || wdt < 0 || wdt > 2)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xdt == kBf16)
    return forward<bf16>(x, w, wdt, y, rows, d, eps, cluster, threads, vec,
                         st);
  if (xdt == kF16)
    return forward<__half>(x, w, wdt, y, rows, d, eps, cluster, threads,
                           vec, st);
  return forward<float>(x, w, wdt, y, rows, d, eps, cluster, threads, vec,
                        st);
}

// x, g [rows, d] (xdt), w [d] (wdt) -> dx [rows, d] (xdt), dw [d] (wdt);
// part: f32 scratch [grid, d]. `grid` CTAs of `threads`, `slots` slots a
// thread. Returns -1 for what it refuses.
extern "C" int rmsnorm_backward(const void* x, const void* g, const void* w,
                                void* dx, void* dw, void* part, int rows,
                                int d, int xdt, int wdt, float eps,
                                int threads, int slots, int grid, int vec,
                                void* stream) {
  if (rows <= 0 || d <= 0 || xdt < 0 || xdt > 2 || wdt < 0 || wdt > 2)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xdt == kBf16)
    return backward<bf16>(x, g, w, wdt, dx, dw, part, rows, d, eps, threads,
                          slots, grid, vec, st);
  if (xdt == kF16)
    return backward<__half>(x, g, w, wdt, dx, dw, part, rows, d, eps,
                            threads, slots, grid, vec, st);
  return backward<float>(x, g, w, wdt, dx, dw, part, rows, d, eps, threads,
                         slots, grid, vec, st);
}
