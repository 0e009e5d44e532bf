// Rotations of rings of per-shard buffers, several rings in one launch, for
// Hopper (sm_90a): the transport of the ring-overlapped expert all-to-all
// (models/moe.py _moe_block_dropless_ep_ring, where one launch a hop moves
// the f32 carrier and the next bf16 chunk), of ring attention's hops
// (parallel/ring.py: k and v, and in the backward their f32 dk/dv carriers,
// of every tensor shard's ring in one launch), of the pipeline's stage-to-
// stage activations (parallel/pipeline.py) and of any other ring hop of the
// port.
//
// Replaces K9, k8s_dra_driver_tpu/parallel/ring.py::
// _ring_permute_pallas_call: shard i's whole buffer goes into shard
// (i + shift) mod n by one remote DMA, started and waited for inside the
// kernel, one ring a call. Here one launch covers every (source,
// destination) pair of every ring of a group whose source lives on the
// launching device: the wrapper (parallel/ring.py::ring_permute_group)
// passes up to kMaxPairs pairs by value in the kernel's parameters, with
// their byte counts and the prefix sums of their 16-byte units, so a
// launch needs no pointer table in device memory and is captured into a
// CUDA graph as it is. A destination on another card is written through
// its peer pointer (peer access enabled by ring_enable_peer); the wrapper
// then makes the destination card's stream wait on an event recorded
// after the launch -- the TPU kernel's "wait".
//
// Computes, for each pair j < count: dst[j][b] = src[j][b] for every byte
// b < nbytes[j]. Buffers are contiguous, never overlap, and may start at
// any byte (a view with a storage offset); pairs of one launch may differ
// in size (a bf16 chunk beside an f32 carrier) and may be empty.
//
// What bounds it on the H100: bytes. Every byte is read once and written
// once: 2 * sum(nbytes) over 3.35 TB/s on one card (shards on one card copy
// HBM to HBM). Across cards the write crosses NVLink (450 GB/s each way),
// which then bounds it. At the EP decode step a pair is 16-32 KiB, so a
// launch is mostly latency; the design:
// - one flat grid over the 16-byte units of all pairs: thread g of G
//   takes units g, g + G, g + 2G, ..., so pairs of unequal size split
//   evenly and no block idles on a short pair. The grid is sized by
//   bytes, a unit a thread, up to one wave (8 blocks an SM): at the decode
//   step's 16-48 KiB pairs that is a few dozen blocks, every unit in
//   flight at once. A thread loads its unit (ld.global.nc: a launch never
//   writes a source), then stores it. Four or eight loads in flight a
//   thread before the stores, and each block a contiguous span of the
//   units, measured slower (tools/ring_permute_bench.py --explore);
// - a programmatic dependent launch (cudaLaunchKernelEx with programmatic
//   stream serialization): griddepcontrol.wait before the first load lets
//   the launch and the block prologue overlap the previous kernel's tail;
//   griddepcontrol.launch_dependents once the loads are issued;
// - a pair whose pointers are not 16-byte aligned moves each unit in the
//   widest word (8, 4, 2 bytes) both are aligned to, and the ragged last
//   unit of a pair byte by byte.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// 32 pairs: a ring-attention backward hop of 2 tensor shards over 4
// sequence shards on one card (k, v, dk, dv: 8 rings of 4) in one launch.
// The table is then 1.2 KB of the 4 KB a launch's parameters may take.
constexpr int kMaxPairs = 32;
constexpr int kThreads = 256;
constexpr long long kUnit = 16;

struct RingPairs {
  const unsigned char* src[kMaxPairs];
  unsigned char* dst[kMaxPairs];
  long long nbytes[kMaxPairs];
  long long first[kMaxPairs + 1];  // pair j owns units [first[j], first[j+1])
  int align[kMaxPairs];            // the word a full unit moves in: 16..1
  int count;
};

// One unit's `valid` bytes (16 but in a pair's last unit) as a uint4, in
// words of `align` bytes; missing bytes read as zero.
__device__ __forceinline__ uint4 load_unit(const unsigned char* s, int align,
                                           int valid) {
  if (valid == kUnit) {
    if (align == 16) return __ldg(reinterpret_cast<const uint4*>(s));
    if (align == 8) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(s));
      const uint2 b = __ldg(reinterpret_cast<const uint2*>(s) + 1);
      return make_uint4(a.x, a.y, b.x, b.y);
    }
    if (align == 4) {
      const unsigned* p = reinterpret_cast<const unsigned*>(s);
      return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if (valid == kUnit && align == 2) {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = static_cast<unsigned>(__ldg(p + 2 * i)) |
             (static_cast<unsigned>(__ldg(p + 2 * i + 1)) << 16);
  } else {
#pragma unroll
    for (int i = 0; i < kUnit; ++i)
      if (i < valid) w[i / 4] |= static_cast<unsigned>(__ldg(s + i))
                                 << (8 * (i % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store_unit(unsigned char* d, int align,
                                           int valid, uint4 v) {
  if (valid == kUnit) {
    if (align == 16) {
      *reinterpret_cast<uint4*>(d) = v;
      return;
    }
    if (align == 8) {
      reinterpret_cast<uint2*>(d)[0] = make_uint2(v.x, v.y);
      reinterpret_cast<uint2*>(d)[1] = make_uint2(v.z, v.w);
      return;
    }
    if (align == 4) {
      unsigned* p = reinterpret_cast<unsigned*>(d);
      p[0] = v.x;
      p[1] = v.y;
      p[2] = v.z;
      p[3] = v.w;
      return;
    }
  }
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  if (valid == kUnit && align == 2) {
    unsigned short* p = reinterpret_cast<unsigned short*>(d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[2 * i] = static_cast<unsigned short>(w[i] & 0xffffu);
      p[2 * i + 1] = static_cast<unsigned short>(w[i] >> 16);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kUnit; ++i)
    if (i < valid)
      d[i] = static_cast<unsigned char>(w[i / 4] >> (8 * (i % 4)));
}

// __grid_constant__: the pair table is read where the launch put it
// (indexed by the pair a unit falls in), not copied to each thread.
__global__ void __launch_bounds__(kThreads)
    ring_permute_kernel(const __grid_constant__ RingPairs p) {
  const long long total = p.first[p.count];
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  // The previous kernel on the stream may still run (a programmatic
  // dependent launch): its writes to the sources, and its reads of the
  // destinations, are done once this returns.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  int j = 0;  // the pair of this thread's unit: units only rise
  bool signalled = false;
  for (long long u = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       u < total; u += threads) {
    while (u >= p.first[j + 1]) ++j;
    const long long off = (u - p.first[j]) * kUnit;
    const long long left = p.nbytes[j] - off;
    const int valid = static_cast<int>(left < kUnit ? left : kUnit);
    const uint4 v = load_unit(p.src[j] + off, p.align[j], valid);
    if (!signalled) {
      asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
      signalled = true;
    }
    store_unit(p.dst[j] + off, p.align[j], valid, v);
  }
}

int word_of(uintptr_t a) {
  for (int w = 16; w > 1; w /= 2)
    if ((a & static_cast<uintptr_t>(w - 1)) == 0) return w;
  return 1;
}

}  // namespace

// srcs / dsts / nbytes: host arrays of `count` entries (read here, at the
// launch, into the kernel's parameters); a pair may hold 0 bytes. The
// grid takes at most `max_blocks` blocks. Returns 0 with no launch where
// every pair is empty, -1 on bad arguments, else the launch's CUDA error.
extern "C" int ring_permute_group(const void* const* srcs, void* const* dsts,
                                  const long long* nbytes, int count,
                                  int max_blocks, void* stream) {
  if (count < 1 || count > kMaxPairs || max_blocks < 1) return -1;
  RingPairs p = {};
  p.count = count;
  p.first[0] = 0;
  for (int j = 0; j < count; ++j) {
    if (nbytes[j] < 0) return -1;
    p.src[j] = static_cast<const unsigned char*>(srcs[j]);
    p.dst[j] = static_cast<unsigned char*>(dsts[j]);
    p.nbytes[j] = nbytes[j];
    p.align[j] = word_of(reinterpret_cast<uintptr_t>(srcs[j]) |
                         reinterpret_cast<uintptr_t>(dsts[j]));
    p.first[j + 1] = p.first[j] + (nbytes[j] + kUnit - 1) / kUnit;
  }
  const long long total = p.first[count];
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ring_permute_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Lets `device` write into `peer`'s memory. 0 once enabled (or already
// enabled), -2 where the cards cannot reach each other, else the CUDA error.
extern "C" int ring_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return -2;
  int current = 0;
  err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky-free "already enabled" error
    err = cudaSuccess;
  }
  cudaSetDevice(current);
  return static_cast<int>(err);
}
