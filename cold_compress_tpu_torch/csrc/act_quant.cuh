// Per-row int8 activation quantization, the prologue of the W4A8 and W8A8
// kernels (w4a8_gemv.cu, w8a8_gemv.cu, w4a8_gemm.cu). Bit-identical to
// cold_compress_tpu/ops/pallas_qmm.py::_quantize_rows:
//   sx = max(absmax, 1e-8) * f32(1/127) (XLA folds the division by the
//        constant 127 into a multiplication by its f32 reciprocal),
//   xq = clip(rint(x / sx), -127, 127) (round half to even, IEEE division).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <int kWarps>
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
  return m;
}

// Quantizes rows l0 .. l0 + nrows - 1 of x [L, IN] bf16 into xq [nrows][IN]
// and sx [nrows] (shared memory). red holds kWarps floats. Every thread of
// the block must call it; it ends with a barrier.
template <int kWarps>
__device__ void quantize_rows_int8(const __nv_bfloat16* __restrict__ x, int IN, int l0,
                                   int nrows, int8_t* xq, float* sx, float* red) {
  constexpr int kThreads = kWarps * 32;
  const int tid = threadIdx.x;
  for (int r = 0; r < nrows; ++r) {
    const __nv_bfloat16* xr = x + (size_t)(l0 + r) * IN;
    float amax = 0.f;
    for (int i = tid; i < IN; i += kThreads)
      amax = fmaxf(amax, fabsf(__bfloat162float(xr[i])));
    amax = block_max<kWarps>(amax, red);
    const float s = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
    for (int i = tid; i < IN; i += kThreads) {
      float q = rintf(__fdiv_rn(__bfloat162float(xr[i]), s));
      q = fminf(fmaxf(q, -127.f), 127.f);
      xq[r * IN + i] = (int8_t)q;
    }
    if (tid == 0) sx[r] = s;
  }
  __syncthreads();
}

// The same quantization from registers (w4a8_gemv.cu, w4a8_gemm.cu).
// Per element, clip(rint(v / s)) with an IEEE division, from rs = 1/s
// (rounded): |v / s| < 127.0001, so v * rs is within
// 2.3e-5 of the division's result, and the two can round to different
// integers only within that distance of a half-integer. There (rarely) the
// division is done.
__device__ __noinline__ float rint_div(float v, float s) { return rintf(__fdiv_rn(v, s)); }

__device__ __forceinline__ int quant_int8(float v, float s, float rs) {
  const float p = v * rs;
  float q = rintf(p);
  if (fabsf(p - q) > 0.5f - 1e-4f) q = rint_div(v, s);
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

// Eight bf16 inputs (one 16-byte chunk): their largest |x|.
__device__ __forceinline__ float absmax8(const uint4& v) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    m = fmaxf(m, fabsf(__uint_as_float(u[e] << 16)));
    m = fmaxf(m, fabsf(__uint_as_float(u[e] & 0xFFFF0000u)));
  }
  return m;
}

// Quantizes 8 inputs to int8 (packed little-endian); returns their sum.
__device__ __forceinline__ int quant8(const uint4& v, float s, float rs, uint2* out) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  uint32_t packed[2] = {0u, 0u};
  int sum = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int a = quant_int8(__uint_as_float(u[e] << 16), s, rs);
    const int b = quant_int8(__uint_as_float(u[e] & 0xFFFF0000u), s, rs);
    sum += a + b;
    packed[e >> 1] |= ((uint32_t)(a & 0xFF) | ((uint32_t)(b & 0xFF) << 8)) << (16 * (e & 1));
  }
  *out = make_uint2(packed[0], packed[1]);
  return sum;
}
