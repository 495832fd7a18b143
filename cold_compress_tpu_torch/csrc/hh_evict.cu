// Fused heavy-hitter eviction step, in place, and the decode step's
// rotate-and-insert built on it.
//
// hh_evict_kernel replaces the TPU kernel cold_compress_tpu/ops/pallas_evict.py::
// fused_hh_evict (history_window_size 1, no attention thresholding):
//   avg = num / max(denom, 1)                 (f32, IEEE division)
//   avg = 1 where pos < global or pos >= input_pos - recent   (protected)
//   avg = 0 where pos == -1                                    (empty)
//   idx = argmin(avg), the first index on ties
//   num[idx] = 0, denom[idx] = 0
// The result is bit-identical to the plain version: the same f32 values and
// an exact argmin.
//
// hh_evict_kernel_insert replaces no TPU kernel: it is the eviction above
// fused with its neighbours in a decode step over a one-slot heavy-hitter
// history and a kv8 cache (the JAX package leaves them to XLA). In the same
// launch each (lane, KV head) block rotates its G query rows and its K row
// (models/rope.py::apply_rotary_emb), quantizes the rotated K row and the V
// row to 8 bits (caches/base.py::quantize_rows) and writes them, their
// scales and zeros, the position, the mask bit and the filled count at the
// evicted slot. Every value is computed as the eager operations compute it,
// each product, difference and quotient rounded once in f32 (no contraction
// into an FMA), so the results are the plain version's bits.
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
// lower index winning ties. The insert starts its loads (one rope pair a
// thread for G <= 7, the V row in one warp) before the eviction's, so they
// share its round trip; the rotation and both rows' quantization finish
// before the argmin is known, which leaves only the stores after it.
//
// With window > 0 the same kernel inserts into a sliding-window layer's
// ring (caches/window.py): the slot is input_pos mod window, given in place
// of the eviction search, and there is no history to zero (num and denom
// are null). Entry point window_insert.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 128;  // the insert's head size
constexpr int kPairs = kHeadDim / 2;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

struct Slot {
  float n;
  int d, p;
};

// The best slot seen so far: its average, index and position.
struct Best {
  float v;
  int i, p;
};

__device__ __forceinline__ void consider(const Slot& s, int c, int lo, int global_tokens,
                                         Best& best) {
  float a = __fdiv_rn(s.n, (float)max(s.d, 1));
  if (s.p < global_tokens || s.p >= lo) a = 1.0f;
  if (s.p == -1) a = 0.0f;
  if (better(a, c, best.v, best.i)) best = Best{a, c, s.p};
}

__device__ __forceinline__ Best warp_best(Best best) {
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best.v, off);
    const int i = __shfl_xor_sync(0xffffffffu, best.i, off);
    const int p = __shfl_xor_sync(0xffffffffu, best.p, off);
    if (better(v, i, best.v, best.i)) best = Best{v, i, p};
  }
  return best;
}

// This thread's best slot of the row [row, row + C) of num, denom and pos:
// every load first, then the comparisons.
__device__ __forceinline__ Best scan_row(const float* __restrict__ num,
                                         const int* __restrict__ denom,
                                         const int* __restrict__ pos, size_t row, int C,
                                         int lo, int global_tokens, int tid) {
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

  Best best{__int_as_float(0x7f800000), C, -1};  // +inf
  for (int v = tid; v < nvec; v += kThreads) {
    const float4 n = num4[v];
    const int4 d = den4[v], p = __ldg(pos4 + v);
    const int c = head + 4 * v;
    consider(Slot{n.x, d.x, p.x}, c, lo, global_tokens, best);
    consider(Slot{n.y, d.y, p.y}, c + 1, lo, global_tokens, best);
    consider(Slot{n.z, d.z, p.z}, c + 2, lo, global_tokens, best);
    consider(Slot{n.w, d.w, p.w}, c + 3, lo, global_tokens, best);
  }
  // The order of consideration cannot change the result: (value, index)
  // pairs are totally ordered.
  if (ce >= 0) consider(extra, ce, lo, global_tokens, best);
  return best;
}

// The row's best slot from each thread's, returned to every thread: each
// warp's best through shared memory (one __syncthreads), then every warp
// reduces the kWarps partials itself.
__device__ __forceinline__ Best block_best(Best best, float* sv, int* si, int* sp, int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  best = warp_best(best);
  if (lane == 0) {
    sv[warp] = best.v;
    si[warp] = best.i;
    sp[warp] = best.p;
  }
  __syncthreads();
  best = lane < kWarps ? Best{sv[lane], si[lane], sp[lane]}
                       : Best{__int_as_float(0x7f800000), C, -1};
  return warp_best(best);
}

__global__ void __launch_bounds__(kThreads)
hh_evict_kernel(float* __restrict__ num,          // [B, H, C]
                int* __restrict__ denom,          // [B, H, C]
                const int* __restrict__ pos,      // [B, H, C]
                const int* __restrict__ ipos,     // [B]
                int* __restrict__ idx,            // [B, H]
                int H, int C, int global_tokens, int recent_window) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps], sp[kWarps];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t row = ((size_t)b * H + h) * C;
  const int lo = ipos[b] - recent_window;
  const Best best = block_best(scan_row(num, denom, pos, row, C, lo, global_tokens, threadIdx.x),
                               sv, si, sp, C);
  if (threadIdx.x == 0) {
    // Every slot's value is finite, so best.i < C.
    idx[(size_t)b * H + h] = best.i;
    num[row + best.i] = 0.0f;
    denom[row + best.i] = 0;
  }
}

// One 128-value row quantized to 8 bits by one warp, 4 values a lane (lane
// l holds values 4l .. 4l + 3), as caches/base.py::quantize_rows: mn and mx
// over the row, rng = max(mx - mn, 1e-6), scale = rng / 255, zero = mn +
// scale * 128, q = clip(rint((x - mn) / scale), 0, 255). Returns the lane's
// four bytes (little-endian); scale and zero reach every lane.
__device__ __forceinline__ uint32_t quantize_row8(const float (&x)[4], float& scale,
                                                  float& zero) {
  float mn = fminf(fminf(x[0], x[1]), fminf(x[2], x[3]));
  float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  const float rng = fmaxf(__fsub_rn(mx, mn), 1e-6f);
  scale = __fdiv_rn(rng, 255.0f);
  zero = __fadd_rn(mn, __fmul_rn(scale, 128.0f));
  uint32_t packed = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float r = rintf(__fdiv_rn(__fsub_rn(x[k], mn), scale));
    packed |= (uint32_t)fminf(fmaxf(r, 0.0f), 255.0f) << (8 * k);
  }
  return packed;
}

// Rope pair t of a block: pair t % 64 of query row t / 64 (< G) or, for
// t / 64 == G, of the K row; its (cos, sin) is pair t % 64 of the lane's
// rope row. models/rope.py: (x0 cos - x1 sin, x1 cos + x0 sin) in f32, each
// product and sum rounded once, then rounded to bf16.
struct RopePair {
  __nv_bfloat162 x;
  float2 cs;
};

__device__ __forceinline__ RopePair load_pair(const __nv_bfloat16* __restrict__ yb,
                                              const float* __restrict__ fb, int h, int G,
                                              int Dq, int t) {
  const int j = t / kPairs, i = t % kPairs;
  const __nv_bfloat16* src =
      j < G ? yb + (size_t)(h * G + j) * kHeadDim : yb + Dq + (size_t)h * kHeadDim;
  return RopePair{reinterpret_cast<const __nv_bfloat162*>(src)[i],
                  reinterpret_cast<const float2*>(fb)[i]};
}

__device__ __forceinline__ void rotate_pair(const RopePair& r, __nv_bfloat16* __restrict__ qb,
                                            float* sk, int h, int G, int t) {
  const int j = t / kPairs, i = t % kPairs;
  const float x0 = __low2float(r.x), x1 = __high2float(r.x);
  const float c = r.cs.x, s = r.cs.y;
  const __nv_bfloat16 o0 = __float2bfloat16_rn(__fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s)));
  const __nv_bfloat16 o1 = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x1, c), __fmul_rn(x0, s)));
  if (j < G) {
    reinterpret_cast<__nv_bfloat162*>(qb + (size_t)(h * G + j) * kHeadDim)[i] =
        __halves2bfloat162(o0, o1);
  } else {
    sk[2 * i] = __bfloat162float(o0);
    sk[2 * i + 1] = __bfloat162float(o1);
  }
}

__global__ void __launch_bounds__(kThreads)
hh_evict_kernel_insert(const __nv_bfloat16* __restrict__ y,  // [B, ystride]: q | k | v
                       const float* __restrict__ freqs,      // [B or 1, 64, 2]: (cos, sin)
                       const int* __restrict__ ipos,         // [B or 1]
                       float* __restrict__ num,              // [B, H, C]
                       int* __restrict__ denom,              // [B, H, C]
                       int* __restrict__ pos,                // [B, H, C]
                       bool* __restrict__ mask,              // [B, H, C]
                       int* __restrict__ cache_ct,           // [B, H]
                       uint8_t* __restrict__ kc,             // [B, H, C, 128]
                       uint8_t* __restrict__ vc,             // [B, H, C, 128]
                       float* __restrict__ k_scales, float* __restrict__ k_zeros,  // [B, H, C]
                       float* __restrict__ v_scales, float* __restrict__ v_zeros,  // [B, H, C]
                       __nv_bfloat16* __restrict__ q,        // [B, H * G, 1, 128]
                       int* __restrict__ idx,                // [B, H]
                       int H, int G, int C, int ystride, int fstride, int pstride,
                       int global_tokens, int recent_window, int window) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps], sp[kWarps];
  __shared__ float sk[kHeadDim];  // the rotated K row (bf16 values)
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row = ((size_t)b * H + h) * C;
  const int Dq = H * G * kHeadDim;
  const __nv_bfloat16* yb = y + (size_t)b * ystride;
  const float* fb = freqs + (size_t)b * fstride;
  __nv_bfloat16* qb = q + (size_t)b * H * G * kHeadDim;
  const int npairs = (G + 1) * kPairs;
  const int input_pos = ipos[(size_t)b * pstride];

  // Loads ahead of the eviction's: each thread's first rope pair, and the
  // V row in warp 1.
  RopePair first{};
  if (tid < npairs) first = load_pair(yb, fb, h, G, Dq, tid);
  float vx[4];
  if (warp == 1) {
    const uint2 raw = reinterpret_cast<const uint2*>(yb + Dq + (size_t)(H + h) * kHeadDim)[lane];
    const __nv_bfloat162 v01 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 v23 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    vx[0] = __low2float(v01);
    vx[1] = __high2float(v01);
    vx[2] = __low2float(v23);
    vx[3] = __high2float(v23);
  }
  Best best{__int_as_float(0x7f800000), C, -1};  // +inf
  if (window == 0) {
    best = scan_row(num, denom, pos, row, C, input_pos - recent_window, global_tokens, tid);
  } else if (tid == 0) {  // the ring's slot; block_best hands it to every thread
    const int s = input_pos % window;
    best = Best{0.f, s, pos[row + s]};
  }

  if (tid < npairs) rotate_pair(first, qb, sk, h, G, tid);
  for (int t = tid + kThreads; t < npairs; t += kThreads)  // G >= 8
    rotate_pair(load_pair(yb, fb, h, G, Dq, t), qb, sk, h, G, t);
  float scale = 0.f, zero = 0.f;
  uint32_t bytes = 0;
  if (warp == 1) bytes = quantize_row8(vx, scale, zero);

  best = block_best(best, sv, si, sp, C);  // its __syncthreads also publishes sk
  if (warp > 1) return;
  if (warp == 0) {
    const float kx[4] = {sk[4 * lane], sk[4 * lane + 1], sk[4 * lane + 2], sk[4 * lane + 3]};
    bytes = quantize_row8(kx, scale, zero);
  }
  // Every slot's value is finite, so best.i < C.
  const size_t slot = row + best.i;
  reinterpret_cast<uint32_t*>((warp == 0 ? kc : vc) + slot * kHeadDim)[lane] = bytes;
  if (lane != 0) return;
  if (warp == 1) {
    v_scales[slot] = scale;
    v_zeros[slot] = zero;
    return;
  }
  k_scales[slot] = scale;
  k_zeros[slot] = zero;
  cache_ct[(size_t)b * H + h] += best.p == -1;
  pos[slot] = input_pos;
  mask[slot] = true;
  if (window == 0) {
    num[slot] = 0.0f;
    denom[slot] = 0;
  }
  idx[(size_t)b * H + h] = best.i;
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

// ystride: elements of y per lane ((H * G + 2 * H) * 128 for a contiguous
// projection); fstride: 128 for a rope row per lane, 0 for one shared row;
// pstride: 1 for a position per lane, 0 for one shared position.
extern "C" int hh_evict_insert(const void* y, const void* freqs, const void* ipos, void* num,
                               void* denom, void* pos, void* mask, void* cache_ct, void* kc,
                               void* vc, void* k_scales, void* k_zeros, void* v_scales,
                               void* v_zeros, void* q, void* idx, int B, int H, int G, int C,
                               int ystride, int fstride, int pstride, int global_tokens,
                               int recent_window, void* stream) {
  if (B < 1 || H < 1 || G < 1 || C < 1 || ystride < (H * G + 2 * H) * kHeadDim)
    return (int)cudaErrorInvalidValue;
  hh_evict_kernel_insert<<<dim3(H, B), kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, (const float*)freqs, (const int*)ipos, (float*)num,
      (int*)denom, (int*)pos, (bool*)mask, (int*)cache_ct, (uint8_t*)kc, (uint8_t*)vc,
      (float*)k_scales, (float*)k_zeros, (float*)v_scales, (float*)v_zeros,
      (__nv_bfloat16*)q, (int*)idx, H, G, C, ystride, fstride, pstride, global_tokens,
      recent_window, 0);
  return (int)cudaGetLastError();
}

// The insert into a sliding-window ring of C slots at slot input_pos mod C:
// hh_evict_insert's arguments without the history and the eviction's.
extern "C" int window_insert(const void* y, const void* freqs, const void* ipos, void* pos,
                             void* mask, void* cache_ct, void* kc, void* vc, void* k_scales,
                             void* k_zeros, void* v_scales, void* v_zeros, void* q, void* idx,
                             int B, int H, int G, int C, int ystride, int fstride, int pstride,
                             void* stream) {
  if (B < 1 || H < 1 || G < 1 || C < 1 || ystride < (H * G + 2 * H) * kHeadDim)
    return (int)cudaErrorInvalidValue;
  hh_evict_kernel_insert<<<dim3(H, B), kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, (const float*)freqs, (const int*)ipos, nullptr, nullptr,
      (int*)pos, (bool*)mask, (int*)cache_ct, (uint8_t*)kc, (uint8_t*)vc, (float*)k_scales,
      (float*)k_zeros, (float*)v_scales, (float*)v_zeros, (__nv_bfloat16*)q, (int*)idx, H, G,
      C, ystride, fstride, pstride, 0, 0, C);
  return (int)cudaGetLastError();
}
