// int8 weight tiles into bf16 wgmma operands, shared by the int8 wgmma
// bodies: int8_matmul's (quant_matmul.cu), the int8 branches of the fused
// MoE dispatch kernels (moe_dispatch.cu) and the int8 grouped product's
// (grouped_matmul_int8.cu).
//
// Two forms:
//   - Images (the wide bodies): an int8 tile lands by TMA as plain rows
//     (contracted index k, output columns contiguous). A consumer thread
//     converts one group of 8 columns of every RP-th row into a bf16 image
//     of the tile in the 128-byte swizzled MN-major layout a TMA load of a
//     bf16 [K, N] matrix would have left, which wgmma then reads through
//     the transpose bit.
//   - Swapped register fragments (the decode bodies, swap_fragments): the
//     weights' columns are wgmma's M, and each thread converts its A
//     fragments straight from a 128-byte swizzled int8 box into registers,
//     with no image, fence or barrier.

#pragma once

#include "hopper.cuh"  // pack, kRowBytes

namespace {

// Four int8 weights (the bytes of w, byte 0 first) as two bf16 pairs, the
// lower byte in the low half. With u = b + 128 as an unsigned byte,
// masking it into the mantissa of 2^23 gives the f32 2^23 + u (bytes 0 and
// 2) or 2^23 + 256 u (bytes 1 and 3), and one subtraction (or one fma by
// 2^-8) gives b exactly: logic ops and f32 arithmetic, no byte permutes.
// Exact (!PROLOGUE): the f32's high half is bf16(b); PROLOGUE: times the
// byte's column's f32 scale s[i], rounded to bf16 -- q_dequant's rounding.
template <bool PROLOGUE>
__device__ __forceinline__ uint2 cvt4(uint32_t w, const float* s) {
  const uint32_t u = w ^ 0x80808080u, v = u >> 16;
  float f[4];
  f[0] = __uint_as_float((u & 0xFFu) | 0x4B000000u) - 8388736.f;
  f[1] = fmaf(__uint_as_float((u & 0xFF00u) | 0x4B000000u), 0.00390625f,
              -32896.f);
  f[2] = __uint_as_float((v & 0xFFu) | 0x4B000000u) - 8388736.f;
  f[3] = fmaf(__uint_as_float((v & 0xFF00u) | 0x4B000000u), 0.00390625f,
              -32896.f);
  uint32_t r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (PROLOGUE)
      r[i] = pack(f[2 * i] * s[2 * i], f[2 * i + 1] * s[2 * i + 1]);
    else
      r[i] = __byte_perm(__float_as_uint(f[2 * i]),
                         __float_as_uint(f[2 * i + 1]), 0x7632);
  }
  return make_uint2(r[0], r[1]);
}

// Eight int8 weights (byte i of lo, then of hi: columns 0-7) as four bf16
// pairs, low column in the low half (cvt4 on each word).
template <bool PROLOGUE>
__device__ __forceinline__ uint4 cvt8(uint32_t lo, uint32_t hi,
                                      const float* s) {
  const uint2 a = cvt4<PROLOGUE>(lo, s), b = cvt4<PROLOGUE>(hi, s + 4);
  return make_uint4(a.x, a.y, b.x, b.y);
}

// One thread's share of a 64-row tile: the 8 int8 columns at `q8` (rows
// `stride` bytes apart) of rows rp, rp + RP, ... into the 16-byte chunk
// `chunk` (0-7: the columns' place in their 64-column box) of those rows
// of the swizzled bf16 image box at `box`.
template <bool PROLOGUE, int RP>
__device__ __forceinline__ void convert_rows(const unsigned char* q8,
                                             int stride, unsigned char* box,
                                             int chunk, int rp,
                                             const float* s) {
#pragma unroll
  for (int i = 0; i < 64 / RP; ++i) {
    const int kr = rp + i * RP;
    const uint2 w = *reinterpret_cast<const uint2*>(q8 + kr * stride);
    *reinterpret_cast<uint4*>(box + kr * kRowBytes +
                              ((chunk ^ (kr & 7)) << 4)) =
        cvt8<PROLOGUE>(w.x, w.y, s);
  }
}

// The swapped form's A fragments of one m64 block and one 64-deep stage:
// `box` is a TMA box of 64 rows (k) x 128 int8 columns with the 128-byte
// swizzle (16-byte chunk ch of row k at chunk ch ^ (k & 7)). Thread (warp,
// g8 = lane / 4, t = lane % 4) of the warpgroup holds the block's rows g8
// and g8 + 8 of its warp's 16 as the box's columns bx and bx + 1 (bx = the
// block's first column + 16 warp + 2 g8: two adjacent columns, so one
// 16-bit load reads both). For k16 step kk its fragment is rows k = 16 kk
// + 2 t, k + 1, k + 8, k + 9 (four 16-bit loads from distinct banks), one
// byte permute and cvt4 a pair of rows; fr[kk] is the mma.sync A fragment
// layout that wgmma's register operand takes. PROLOGUE: s holds the two
// columns' scales as {s(bx), s(bx), s(bx + 1), s(bx + 1)}.
template <bool PROLOGUE>
__device__ __forceinline__ void swap_fragments(const unsigned char* box,
                                               int bx, int t, const float* s,
                                               uint32_t (&fr)[4][4]) {
  auto ld = [&](int k) -> uint32_t {
    return *reinterpret_cast<const uint16_t*>(
        box + k * kRowBytes + (((bx >> 4) ^ (k & 7)) << 4) + (bx & 15));
  };
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = kk * 16 + 2 * t;
    const uint2 lo =
        cvt4<PROLOGUE>(__byte_perm(ld(k), ld(k + 1), 0x5140), s);
    const uint2 hi =
        cvt4<PROLOGUE>(__byte_perm(ld(k + 8), ld(k + 9), 0x5140), s);
    fr[kk][0] = lo.x;
    fr[kk][1] = lo.y;
    fr[kk][2] = hi.x;
    fr[kk][3] = hi.y;
  }
}

}  // namespace
