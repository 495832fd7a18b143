// W8A8 decode matmul: y[L, OUT] = x[L, IN] @ W for an int8 weight with one
// f32 scale per output column (the --head_bits 8 vocab head).
//
// Replaces the TPU kernel cold_compress_tpu/ops/pallas_qmm.py::
// qmm_w8a8_tiled (tiled int8 head): the same function on the port's layout.
//   x is quantized per row to int8 (act_quant.cuh, bit-identical to
//   _quantize_rows); d = sum xq * w is an exact int32 dot (dp4a);
//   y = (float(d) * s_col) * sx in f32, in that order, as the TPU kernel's
//   epilogue (d * s) and its wrapper (* sx) compute it.
//
// Layout: w int8 [OUT, IN], each output column's inputs contiguous (repacked
// once from the checkpoint's [IN, OUT]); s f32 [OUT]. The ragged edge of
// OUT (128256 columns) is masked, so nothing is padded.
//
// Bound on this card: bytes. At L = 1 the kernel reads IN*OUT weight bytes
// and does 2*IN*OUT integer operations, far below the int8 rate. One warp
// streams kCols columns with 16-byte coalesced loads (512 contiguous bytes
// per column per step); the quantized activations sit in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;  // output columns per warp
constexpr int kRows = 4;  // activation rows per block

__global__ void __launch_bounds__(kThreads)
w8a8_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ w,
                 const float* __restrict__ s,
                 float* __restrict__ y, int L, int IN, int OUT) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  int8_t* xq = reinterpret_cast<int8_t*>(smem);            // [kRows][IN]
  float* sx = reinterpret_cast<float*>(smem + kRows * IN);  // [kRows]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int l0 = blockIdx.y * kRows;
  const int nrows = min(kRows, L - l0);
  quantize_rows_int8<kWarps>(x, IN, l0, nrows, xq, sx, red);

  const int col0 = (blockIdx.x * kWarps + warp) * kCols;
  if (col0 >= OUT) return;  // no block-wide barrier follows
  int acc[kCols][kRows];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[c][r] = 0;

  for (int step = 0; step < IN; step += 512) {
    const int base = step + lane * 16;  // this lane's 16 inputs
    const bool active = base < IN;
    int4 wv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = col0 + c;
      if (active && col < OUT)
        wv[c] = __ldg(reinterpret_cast<const int4*>(w + (size_t)col * IN + base));
      else
        wv[c] = make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nrows) break;  // uniform across the warp
      int4 xa = make_int4(0, 0, 0, 0);
      if (active) xa = *reinterpret_cast<const int4*>(xq + r * IN + base);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        int d = acc[c][r];
        d = __dp4a(xa.x, wv[c].x, d);
        d = __dp4a(xa.y, wv[c].y, d);
        d = __dp4a(xa.z, wv[c].z, d);
        d = __dp4a(xa.w, wv[c].w, d);
        acc[c][r] = d;
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = col0 + c;
    const float sc = col < OUT ? s[col] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nrows) break;
      int d = acc[c][r];
      for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (lane == 0 && col < OUT)
        y[(size_t)(l0 + r) * OUT + col] = __fmul_rn(__fmul_rn((float)d, sc), sx[r]);
    }
  }
}

}  // namespace

extern "C" int w8a8_gemv(const void* x, const void* w, const void* s, void* y, int L,
                         int IN, int OUT, void* stream) {
  if (L < 1 || IN < 16 || IN % 16 || OUT < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kRows * IN + kRows * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        w8a8_gemv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int cols_per_block = kWarps * kCols;
  dim3 grid((OUT + cols_per_block - 1) / cols_per_block, (L + kRows - 1) / kRows);
  w8a8_gemv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)s, (float*)y, L, IN, OUT);
  return (int)cudaGetLastError();
}
