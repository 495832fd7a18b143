// W4A8 decode matmul: y[L, OUT] = x[L, IN] @ W for int4 group-wise weights.
//
// Replaces the TPU kernels cold_compress_tpu/ops/pallas_qmm.py::qmm_w4a8_cpt
// (layer projections) and the tiled branch of qmm_w4a8_cp_stacked (vocab
// head): the same function on the port's own byte layout.
//
//   x is quantized per row to int8 (act_quant.cuh): sx = max(absmax, 1e-8)
//   * f32(1/127), xq = clip(rint(x / sx), -127, 127) (round half to even,
//   true division).
//   Per group g of gs inputs: d_g = sum xq * (q - 8) and xs_g = sum xq, both
//   exact in int32; y = sx * sum_g (s_g * d_g + z_g * xs_g) in f32.
//
// Layout ("gemv", repacked once from the checkpoint's rowpack at load):
//   w  uint8 [OUT, IN/2]: column j's inputs are contiguous. Within each
//      4-byte word covering inputs 8k..8k+7, byte b holds q[8k+b] in its low
//      nibble and q[8k+4+b] in its high nibble (q unsigned, 0..15), so
//      (word & 0x0F0F0F0F) and ((word >> 4) & 0x0F0F0F0F) are four int8
//      lanes each that dp4a multiplies with four int8 activations.
//   sz uint32 [OUT, IN/gs]: bf16 scale (low half) and bf16 zero (high half).
//
// Bound on this card: bytes. At L = 1 the kernel reads IN*OUT/2 weight bytes
// and does 2*IN*OUT integer operations, far below the int8 rate. The design
// streams each column's bytes with 16-byte coalesced loads (one warp reads
// 512 contiguous bytes per column per step) and keeps the quantized
// activations in shared memory, read once per 4 columns. Each block
// quantizes x itself in its prologue (no second launch); x is small and
// stays in L2.

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
w4a8_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ w,
                 const uint32_t* __restrict__ sz,
                 float* __restrict__ y, int L, int IN, int OUT, int gs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  const int ng = IN / gs;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);                // [kRows][IN]
  int* xs = reinterpret_cast<int*>(smem + kRows * IN);          // [kRows][ng]
  float* sx = reinterpret_cast<float*>(xs + kRows * ng);        // [kRows]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int l0 = blockIdx.y * kRows;
  const int nrows = min(kRows, L - l0);

  // ---- prologue: per-row int8 quantization of x ----
  quantize_rows_int8<kWarps>(x, IN, l0, nrows, xq, sx, red);
  // Per-group activation sums xs_g (exact int).
  for (int t = warp; t < nrows * ng; t += kWarps) {
    const int r = t / ng, g = t % ng;
    int acc = 0;
    for (int i = lane; i < gs; i += 32) acc += xq[r * IN + g * gs + i];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) xs[r * ng + g] = acc;
  }
  __syncthreads();

  // ---- main loop: one warp, kCols output columns ----
  const int col0 = (blockIdx.x * kWarps + warp) * kCols;
  if (col0 >= OUT) return;  // no block-wide barrier follows
  const int lpg = gs / 32;  // lanes per group (power of two, <= 32)
  const int IN2 = IN / 2;
  float acc[kCols][kRows];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;

  for (int step = 0; step < IN; step += 1024) {
    const int base = step + lane * 32;  // this lane's 32 inputs
    const bool active = base < IN;
    const int g = active ? base / gs : 0;
    uint4 wv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = col0 + c;
      if (active && col < OUT)
        wv[c] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)col * IN2 + base / 2));
      else
        wv[c] = make_uint4(0u, 0u, 0u, 0u);
    }
    uint32_t szv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = col0 + c;
      szv[c] = (active && col < OUT) ? __ldg(sz + (size_t)col * ng + g) : 0u;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nrows) break;  // uniform across the warp
      int4 xa = make_int4(0, 0, 0, 0), xb = make_int4(0, 0, 0, 0);
      if (active) {
        const int4* xp = reinterpret_cast<const int4*>(xq + r * IN + base);
        xa = xp[0];
        xb = xp[1];
      }
      const int xsum = active ? xs[r * ng + g] : 0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const uint32_t m = 0x0F0F0F0Fu;
        int d = 0;
        d = __dp4a(xa.x, (int)(wv[c].x & m), d);
        d = __dp4a(xa.y, (int)((wv[c].x >> 4) & m), d);
        d = __dp4a(xa.z, (int)(wv[c].y & m), d);
        d = __dp4a(xa.w, (int)((wv[c].y >> 4) & m), d);
        d = __dp4a(xb.x, (int)(wv[c].z & m), d);
        d = __dp4a(xb.y, (int)((wv[c].z >> 4) & m), d);
        d = __dp4a(xb.z, (int)(wv[c].w & m), d);
        d = __dp4a(xb.w, (int)((wv[c].w >> 4) & m), d);
        for (int off = 1; off < lpg; off <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if (active && (lane & (lpg - 1)) == 0) {
          // d = sum xq * q over the group; d_g = d - 8 * xs_g.
          const float s = __uint_as_float(szv[c] << 16);
          const float z = __uint_as_float(szv[c] & 0xFFFF0000u);
          acc[c][r] += s * (float)(d - 8 * xsum) + z * (float)xsum;
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nrows) break;
      float v = acc[c][r];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int col = col0 + c;
      if (lane == 0 && col < OUT) y[(size_t)(l0 + r) * OUT + col] = v * sx[r];
    }
  }
}

}  // namespace

extern "C" int w4a8_gemv(const void* x, const void* w, const void* sz, void* y,
                         int L, int IN, int OUT, int gs, void* stream) {
  const int ng = IN / gs;
  const size_t smem = (size_t)kRows * IN + (size_t)kRows * ng * 4 + kRows * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        w4a8_gemv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int cols_per_block = kWarps * kCols;
  dim3 grid((OUT + cols_per_block - 1) / cols_per_block, (L + kRows - 1) / kRows);
  w4a8_gemv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)w, (const uint32_t*)sz,
      (float*)y, L, IN, OUT, gs);
  return (int)cudaGetLastError();
}
