// The W4A8 dot of K1 (w4a8_gemv.cu), shared with the grouped expert GEMV
// (moe_gemv.cu): 32 int4 weights of one column in the "gemv" layout (one
// 16-byte chunk: byte b of the word covering inputs 8k..8k+7 holds q[8k+b]
// in its low nibble and q[8k+4+b] in its high nibble, q unsigned) against
// 32 int8 activations (xa: inputs 0..15, xb: 16..31), and a group's term
// from its exact integer dot and activation sum.
#pragma once

#include <stdint.h>

__device__ __forceinline__ int dot32(const int4& xa, const int4& xb, const uint4& w) {
  const uint32_t m = 0x0F0F0F0Fu;
  int d = __dp4a(xa.x, (int)(w.x & m), 0);
  d = __dp4a(xa.y, (int)((w.x >> 4) & m), d);
  d = __dp4a(xa.z, (int)(w.y & m), d);
  d = __dp4a(xa.w, (int)((w.y >> 4) & m), d);
  d = __dp4a(xb.x, (int)(w.z & m), d);
  d = __dp4a(xb.y, (int)((w.z >> 4) & m), d);
  d = __dp4a(xb.z, (int)(w.w & m), d);
  return __dp4a(xb.w, (int)((w.w >> 4) & m), d);
}

// s * (d - 8 * xs) + z * xs for one group, d = sum xq * q over the group.
__device__ __forceinline__ float group_term(int d, int xs, uint32_t sz) {
  const float s = __uint_as_float(sz << 16);
  const float z = __uint_as_float(sz & 0xFFFF0000u);
  return s * (float)(d - 8 * xs) + z * (float)xs;
}

