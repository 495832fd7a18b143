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
// C = 2048, 196 KB) the bytes take well under a microsecond, so the time is
// latency: the launch, one round trip to memory, the reduction and the
// dependent write. One block of 512 threads per (b, h) row. Each thread
// first issues every load it needs, as 16-byte vectors of num, denom and pos
// (one of each at C = 2048), and only then computes: one memory round trip
// instead of one per slot. A row starts on a 16-byte boundary only when
// (row * C) % 4 == 0; the slots before the first boundary (head) and after
// the last whole vector (tail) are read as scalars by the first threads, in
// the same round trip. The block then reduces (value, index) pairs, the
// lower index winning ties.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

struct Slot {
  float n;
  int d, p;
};

__device__ __forceinline__ void consider(const Slot& s, int c, int lo, int global_tokens,
                                         float& best, int& best_i) {
  float a = __fdiv_rn(s.n, (float)max(s.d, 1));
  if (s.p < global_tokens || s.p >= lo) a = 1.0f;
  if (s.p == -1) a = 0.0f;
  if (better(a, c, best, best_i)) {
    best = a;
    best_i = c;
  }
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

  // Slots [head, head + 4 * nvec) in 16-byte vectors; the rest as scalars.
  const int head = min(C, (int)((4 - (row & 3)) & 3));
  const int nvec = (C - head) >> 2;
  const int tail0 = head + 4 * nvec;
  const float4* num4 = reinterpret_cast<const float4*>(num + row + head);
  const int4* den4 = reinterpret_cast<const int4*>(denom + row + head);
  const int4* pos4 = reinterpret_cast<const int4*>(pos + row + head);

  // The head's and tail's scalars (fewer than 4 slots each), one per thread
  // of the first threads, are loaded first; then each thread's vectors.
  int ce = -1;
  if (tid < head) ce = tid;
  else if (tid - head < C - tail0) ce = tail0 + tid - head;
  Slot extra{0.f, 0, -1};
  if (ce >= 0) extra = Slot{num[row + ce], denom[row + ce], pos[row + ce]};

  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = C;
  for (int v = tid; v < nvec; v += kThreads) {
    const float4 n = num4[v];
    const int4 d = den4[v], p = __ldg(pos4 + v);
    const int c = head + 4 * v;
    consider(Slot{n.x, d.x, p.x}, c, lo, global_tokens, best, best_i);
    consider(Slot{n.y, d.y, p.y}, c + 1, lo, global_tokens, best, best_i);
    consider(Slot{n.z, d.z, p.z}, c + 2, lo, global_tokens, best, best_i);
    consider(Slot{n.w, d.w, p.w}, c + 3, lo, global_tokens, best, best_i);
  }
  // The order of consideration cannot change the result: (value, index)
  // pairs are totally ordered.
  if (ce >= 0) consider(extra, ce, lo, global_tokens, best, best_i);

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
  if (warp == 0) {
    best = lane < kWarps ? sv[lane] : __int_as_float(0x7f800000);
    best_i = lane < kWarps ? si[lane] : C;
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, best, off);
      const int i = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (better(v, i, best, best_i)) {
        best = v;
        best_i = i;
      }
    }
    if (lane == 0) {
      // Every slot's value is finite, so best_i < C.
      idx[(size_t)b * H + h] = best_i;
      num[row + best_i] = 0.0f;
      denom[row + best_i] = 0;
    }
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
