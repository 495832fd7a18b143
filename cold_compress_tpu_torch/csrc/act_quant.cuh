// Per-row int8 activation quantization, the prologue of the W4A8 and W8A8
// kernels (w4a8_gemv.cu, w8a8_gemv.cu). Bit-identical to
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
