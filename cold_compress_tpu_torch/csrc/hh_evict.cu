// Fused heavy-hitter eviction step, in place.
//
// Replaces the TPU kernel cold_compress_tpu/ops/pallas_evict.py::
// fused_hh_evict (history_window_size 1, no attention thresholding):
//   avg = num / max(denom, 1)                 (f32, IEEE division)
//   avg = 1 where pos < global or pos >= input_pos - recent   (protected)
//   avg = 0 where pos == -1                                    (empty)
//   idx = argmin(avg), the first index on ties
//   num[idx] = 0, denom[idx] = 0
// The result is bit-identical to the plain version: the same f32 values and
// an exact argmin.
//
// Bound on this card: bytes, but at the main path's sizes (B*H = 8 rows of
// C = 2048) the bytes take well under a microsecond and the launch itself
// dominates. What the kernel buys is the host side: one launch instead of
// about ten eager ones per layer per decode step. One block per (b, h) row;
// each thread keeps the first minimum of its strided slots, then the block
// reduces (value, index) pairs with the lower index winning ties.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
hh_evict_kernel(float* __restrict__ num,          // [B, H, C]
                int* __restrict__ denom,          // [B, H, C]
                const int* __restrict__ pos,      // [B, H, C]
                const int* __restrict__ ipos,     // [B]
                int* __restrict__ idx,            // [B, H]
                int H, int C, int global_tokens, int recent_window) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t row = ((size_t)b * H + h) * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lo = ipos[b] - recent_window;

  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = C;
  for (int c = tid; c < C; c += kThreads) {
    const int p = pos[row + c];
    float a = __fdiv_rn(num[row + c], (float)max(denom[row + c], 1));
    if (p < global_tokens || p >= lo) a = 1.0f;
    if (p == -1) a = 0.0f;
    if (better(a, c, best, best_i)) {
      best = a;
      best_i = c;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, off);
    const int i = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (better(v, i, best, best_i)) {
      best = v;
      best_i = i;
    }
  }
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (better(sv[w], si[w], best, best_i)) {
        best = sv[w];
        best_i = si[w];
      }
    // Every slot's value is finite, so best_i < C.
    idx[(size_t)b * H + h] = best_i;
    num[row + best_i] = 0.0f;
    denom[row + best_i] = 0;
  }
}

}  // namespace

extern "C" int hh_evict(void* num, void* denom, const void* pos, const void* ipos,
                        void* idx, int B, int H, int C, int global_tokens,
                        int recent_window, void* stream) {
  if (B < 1 || H < 1 || C < 1) return (int)cudaErrorInvalidValue;
  hh_evict_kernel<<<dim3(H, B), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)num, (int*)denom, (const int*)pos, (const int*)ipos, (int*)idx, H, C,
      global_tokens, recent_window);
  return (int)cudaGetLastError();
}
