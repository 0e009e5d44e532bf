// One rotation of a ring of per-shard buffers, for Hopper (sm_90a): the
// transport of the ring-overlapped expert all-to-all (models/moe.py
// _moe_block_dropless_ep_ring) and of any other ring hop of the port.
//
// Replaces K9, k8s_dra_driver_tpu/parallel/ring.py::
// _ring_permute_pallas_call: shard i's whole buffer goes into shard
// (i + shift) mod n by one remote DMA, started and waited for inside the
// kernel. Here one launch covers every shard whose source buffer lives on
// the launching device: the wrapper (parallel/ring.py::ring_permute_kernel)
// passes up to kMaxShards (source, destination) pointer pairs by value in
// the kernel's parameters, so a launch needs no pointer table in device
// memory and can be captured into a CUDA graph as it is. A destination on
// another card is written through its peer pointer (peer access enabled by
// ring_enable_peer); the wrapper then makes the destination card's stream
// wait on an event recorded after the launch -- the TPU kernel's "wait".
//
// Computes, for each pair j < count: dst[j][b] = src[j][b] for every byte
// b < nbytes. Buffers are contiguous, never overlap, and may start at any
// byte (a view with a storage offset): each pair moves in the widest word
// (16, 8, 4, 2 bytes) that both of its pointers are aligned to, then a
// byte tail.
//
// What bounds it on the H100: bytes. Every byte is read once and written
// once: 2 * n * nbytes over 3.35 TB/s on one card (shards on one card copy
// HBM to HBM). Across cards the write crosses NVLink (450 GB/s each way),
// which then bounds it. Blocks stride over their pair's buffer with
// 16-byte loads and stores, neighbouring threads on neighbouring words;
// grid.y is the pair.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxShards = 8;
constexpr int kThreads = 256;

struct RingPointers {
  const unsigned char* src[kMaxShards];
  unsigned char* dst[kMaxShards];
};

template <typename Word>
__device__ __forceinline__ long long copy_words(const unsigned char* src,
                                                unsigned char* dst,
                                                long long nbytes,
                                                long long first,
                                                long long stride) {
  const long long words = nbytes / static_cast<long long>(sizeof(Word));
  const Word* s = reinterpret_cast<const Word*>(src);
  Word* d = reinterpret_cast<Word*>(dst);
  for (long long i = first; i < words; i += stride) d[i] = s[i];
  return words * static_cast<long long>(sizeof(Word));
}

// __grid_constant__: the pointer table is read where the launch put it
// (indexed by blockIdx.y), not copied to each thread's stack.
__global__ void __launch_bounds__(kThreads)
    ring_permute_kernel(const __grid_constant__ RingPointers p,
                        long long nbytes) {
  const unsigned char* src = p.src[blockIdx.y];
  unsigned char* dst = p.dst[blockIdx.y];
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  long long done = 0;
  if ((align & 15) == 0) {
    done = copy_words<uint4>(src, dst, nbytes, first, stride);
  } else if ((align & 7) == 0) {
    done = copy_words<uint2>(src, dst, nbytes, first, stride);
  } else if ((align & 3) == 0) {
    done = copy_words<unsigned int>(src, dst, nbytes, first, stride);
  } else if ((align & 1) == 0) {
    done = copy_words<unsigned short>(src, dst, nbytes, first, stride);
  }
  for (long long i = done + first; i < nbytes; i += stride) dst[i] = src[i];
}

}  // namespace

// srcs / dsts: host arrays of `count` device pointers (read here, at the
// launch, into the kernel's parameters). `blocks` blocks per pair.
extern "C" int ring_permute(const void* const* srcs, void* const* dsts,
                            int count, long long nbytes, int blocks,
                            void* stream) {
  if (count < 1 || count > kMaxShards || nbytes <= 0 || blocks < 1 ||
      blocks > 65535)
    return -1;
  RingPointers p = {};
  for (int j = 0; j < count; ++j) {
    p.src[j] = static_cast<const unsigned char*>(srcs[j]);
    p.dst[j] = static_cast<unsigned char*>(dsts[j]);
  }
  ring_permute_kernel<<<dim3(blocks, count), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p, nbytes);
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
