// Grouped W4A8 GEMV over the experts a decode step selected (a mixture of
// experts' MLP at decode): two launches a layer, whatever the lanes chose.
//
// Replaces no TPU kernel (the JAX package has no expert layer). The router
// (softmax, top k, renormalisation) runs before it on the card and leaves
// ids [B, K] (int64, each lane's K distinct experts) and weights [B, K]
// (f32) in device memory, which both launches read: the step stays one
// captured CUDA graph, whichever experts a replay selects.
//
//   moe_w4a8_gemv_kernel<0> (gate and up, with SwiGLU): for every pair p = (b, k),
//     h[p] = silu(bf16(x[b] W13_e)) * (x[b] W13'_e), e = ids[p], rounded as
//     the eager ops round: each projection's f32 result to bf16, silu in
//     f32 to bf16, the product to bf16. W13_e's columns are interleaved
//     (2j gate j, 2j + 1 up j) so that one warp holds both of a pair.
//   moe_w4a8_gemv_kernel<1> (down, with the weighted combine): per pair the f32
//     row y[p] = h[p] W2_e into a workspace, then out[b] = bf16(sum_k
//     w[b, k] * y[(b, k)]), the products and sums rounded in k order.
//
// Each projection is K1's function (w4a8_gemv.cu): the rows quantized to
// int8 per row (act_quant.cuh), exact integer dots of 32 inputs against the
// "gemv" layout's int4 chunks (w4a8_dot.cuh), s * (d - 8 xs) + z * xs per
// chunk of a group, y = sx * sum. Two launches give the same bits: every
// sum has a fixed order (the combine too: the last CTA of a column tile
// sums its workspace rows in k order, no float atomics).
//
// Grid: (column tiles, distinct experts at most). Every CTA finds the step's
// distinct experts from the ids (a bitmap in shared memory) and takes the
// u-th in ascending order (blockIdx.y = u), or exits where the lanes chose
// fewer. So each selected expert's int4 leaves are read once per step,
// however many lanes chose it: its CTA quantizes the rows of every lane
// that chose it and streams each column once against all of them. A launch
// takes at most kMaxRows lanes; ops/moe.py launches a larger batch in groups
// of kMaxRows lanes (a lane's combine reads only its own K rows), so an
// expert is read once per group that chose it. The CTAs
// of tile 0 of the gate launch each add one to a device counter of distinct
// experts (per layer), which the tracer reads.
//
// Bound on this card: bytes (each distinct expert's 3.29 MB at Mellum2's
// widths). A warp owns 4 columns; each lane loads all its 16-byte chunks of
// them first (up to 12 loads in flight a lane), then multiplies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "w4a8_dot.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCPW = 4;                  // columns per warp
constexpr int kCols = kWarps * kCPW;     // columns per CTA tile
constexpr int kMaxRows = 8;              // lanes (rows of one expert) per step, at most
constexpr int kMaxIt = 3;                // 32-input chunks a lane takes per column: IN <= 3072
constexpr int kMaxIn = 32 * 32 * kMaxIt;
constexpr int kMaxPairs = 256;
constexpr int kMaxExperts = 1024;

__device__ __forceinline__ float silu(float v) { return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v))); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// MODE 0: gate and up (OUT = 2F interleaved columns), h [P, F] bf16 out.
// MODE 1: down (OUT = D), the workspace ws [P, D] f32, then out [B, D] bf16.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
moe_w4a8_gemv_kernel(const __nv_bfloat16* __restrict__ x,  // MODE 0: [B, IN]; 1: [P, IN]
                const int64_t* __restrict__ ids,      // [B, K]
                const float* __restrict__ wts,        // [B, K] (MODE 1)
                const uint8_t* __restrict__ w,        // [E, OUT, IN / 2]
                const uint32_t* __restrict__ sz,      // [E, OUT, IN / gs]
                __nv_bfloat16* __restrict__ h,        // MODE 0: [P, OUT / 2]
                float* __restrict__ ws,               // MODE 1: [P, OUT]
                __nv_bfloat16* __restrict__ out,      // MODE 1: [B, OUT]
                int* __restrict__ arrive,             // MODE 1: [tiles], zero between launches
                int* __restrict__ counter,            // MODE 0: distinct experts, += per step
                int B, int K, int E, int IN, int OUT, int gs) {
  __shared__ uint32_t bits[kMaxExperts / 32];
  __shared__ int rows[kMaxRows];  // pairs p whose expert this CTA serves, in order
  __shared__ int info[3];         // expert, its rows, distinct experts
  __shared__ float red[kWarps];
  __shared__ float sxs[kMaxRows];
  __shared__ __align__(16) int8_t xq[kMaxRows * kMaxIn];
  __shared__ int xsum[kMaxRows * kMaxIn / 32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int P = B * K;
  // ---- 1. the step's distinct experts, and this CTA's ----
  for (int i = tid; i < (E + 31) / 32; i += kThreads) bits[i] = 0u;
  __syncthreads();
  for (int p = tid; p < P; p += kThreads) {
    const int e = (int)ids[p];
    atomicOr(&bits[e >> 5], 1u << (e & 31));
  }
  __syncthreads();
  if (tid == 0) {
    int u = blockIdx.y, expert = -1, total = 0;
    for (int i = 0; i < (E + 31) / 32; ++i) {
      uint32_t m = bits[i];
      const int c = __popc(m);
      if (expert < 0 && u < total + c) {
        for (int r = u - total; r > 0; --r) m &= m - 1;  // drop the lower set bits
        expert = i * 32 + __ffs(m) - 1;
      }
      total += c;
    }
    int n = 0;
    if (expert >= 0)
      for (int p = 0; p < P && n < kMaxRows; ++p)
        if ((int)ids[p] == expert) rows[n++] = p;
    info[0] = expert;
    info[1] = n;
    info[2] = total;
    if (MODE == 0 && expert >= 0 && blockIdx.x == 0) atomicAdd(counter, 1);
  }
  __syncthreads();
  const int expert = info[0], nrows = info[1], distinct = info[2];
  if (expert < 0) return;

  // ---- 2. the rows' activations, int8 per row, with exact sums per 32 inputs ----
  const int nch = IN / 32;
  for (int r = 0; r < nrows; ++r) {
    const int src = MODE == 0 ? rows[r] / K : rows[r];
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)src * IN);
    float m = 0.f;
    for (int i = tid; i < IN / 8; i += kThreads) m = fmaxf(m, absmax8(__ldg(xr + i)));
    m = block_max<kWarps>(m, red);
    const float s = __fmul_rn(fmaxf(m, 1e-8f), 1.0f / 127.0f);
    const float rs = __frcp_rn(s);
    for (int c = tid; c < nch; c += kThreads) {
      int sum = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint2 packed;
        sum += quant8(__ldg(xr + 4 * c + q), s, rs, &packed);
        *reinterpret_cast<uint2*>(xq + r * kMaxIn + 32 * c + 8 * q) = packed;
      }
      xsum[r * (kMaxIn / 32) + c] = sum;
    }
    if (tid == 0) sxs[r] = s;
  }
  __syncthreads();

  // ---- 3. four columns a warp: every chunk's load first, then the dots ----
  const int col0 = blockIdx.x * kCols + warp * kCPW;
  const int in2 = IN / 2;
  const uint8_t* we = w + (size_t)expert * OUT * in2;
  const uint32_t* sze = sz + (size_t)expert * OUT * (IN / gs);
  uint4 wv[kCPW][kMaxIt];
  uint32_t szv[kCPW][kMaxIt];
#pragma unroll
  for (int j = 0; j < kCPW; ++j) {
    const int col = col0 + j;
#pragma unroll
    for (int it = 0; it < kMaxIt; ++it) {
      const int c = lane + 32 * it;
      const bool ok = col < OUT && c < nch;
      wv[j][it] = ok ? __ldg(reinterpret_cast<const uint4*>(we + (size_t)col * in2) + c)
                     : make_uint4(0u, 0u, 0u, 0u);
      szv[j][it] = ok ? __ldg(sze + (size_t)col * (IN / gs) + (32 * c) / gs) : 0u;
    }
  }
  float acc[kCPW][kMaxRows];
#pragma unroll
  for (int j = 0; j < kCPW; ++j)
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[j][r] = 0.f;
#pragma unroll
  for (int it = 0; it < kMaxIt; ++it) {
    const int c = lane + 32 * it;
    if (c >= nch) break;
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r >= nrows) break;
      const int4 xa = *reinterpret_cast<const int4*>(xq + r * kMaxIn + 32 * c);
      const int4 xb = *reinterpret_cast<const int4*>(xq + r * kMaxIn + 32 * c + 16);
      const int xs = xsum[r * (kMaxIn / 32) + c];
#pragma unroll
      for (int j = 0; j < kCPW; ++j) acc[j][r] += group_term(dot32(xa, xb, wv[j][it]), xs, szv[j][it]);
    }
  }
#pragma unroll
  for (int j = 0; j < kCPW; ++j)
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r >= nrows) break;
      float v = acc[j][r];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[j][r] = v * sxs[r];
    }

  // ---- 4. the epilogue ----
  if (MODE == 0) {
    // Columns (2m, 2m + 1) are (gate m, up m): lanes 0 and 1 write one pair each.
    const int m = col0 / 2 + lane;
    if (lane < kCPW / 2 && 2 * m < OUT) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r >= nrows) break;
        const float g = bf16_round(lane == 0 ? acc[0][r] : acc[2][r]);
        const float u = bf16_round(lane == 0 ? acc[1][r] : acc[3][r]);
        h[(size_t)rows[r] * (OUT / 2) + m] = __float2bfloat16_rn(__fmul_rn(bf16_round(silu(g)), u));
      }
    }
    return;
  }
  if (lane < kCPW && col0 + lane < OUT) {
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r >= nrows) break;
      const float v = lane == 0 ? acc[0][r] : lane == 1 ? acc[1][r] : lane == 2 ? acc[2][r] : acc[3][r];
      ws[(size_t)rows[r] * OUT + col0 + lane] = v;
    }
  }
  // The last of the tile's `distinct` CTAs combines the tile's columns.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&arrive[blockIdx.x], 1) == distinct - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int t0 = blockIdx.x * kCols;
  for (int i = tid; i < B * kCols; i += kThreads) {
    const int b = i / kCols, col = t0 + i % kCols;
    if (col >= OUT) continue;
    float s = 0.f;
    for (int k = 0; k < K; ++k)
      s = __fadd_rn(s, __fmul_rn(__ldcg(wts + b * K + k), __ldcg(ws + (size_t)(b * K + k) * OUT + col)));
    out[(size_t)b * OUT + col] = __float2bfloat16_rn(s);
  }
  if (tid == 0) arrive[blockIdx.x] = 0;
}

}  // namespace

// Gate and up with SwiGLU: x [B, IN] bf16, ids [B, K] int64, w13 [E, 2F,
// IN/2] uint8 (columns interleaved gate/up), sz13 [E, 2F, IN/gs] (bf16 scale,
// bf16 zero), h [B*K, F] bf16 out; counter (one int) += distinct experts.
extern "C" int moe_gate_up(const void* x, const void* ids, const void* w, const void* sz,
                           void* h, void* counter, int B, int K, int E, int IN, int OUT, int gs,
                           void* stream) {
  if (B < 1 || B > kMaxRows || K < 1 || B * K > kMaxPairs || E < 1 || E > kMaxExperts ||
      IN % 32 || IN > kMaxIn || gs % 32 || IN % gs || OUT % 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((OUT + kCols - 1) / kCols, min(E, B * K));
  moe_w4a8_gemv_kernel<0><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int64_t*)ids, nullptr, (const uint8_t*)w,
      (const uint32_t*)sz, (__nv_bfloat16*)h, nullptr, nullptr, nullptr, (int*)counter, B, K, E,
      IN, OUT, gs);
  return (int)cudaGetLastError();
}

// Down with the weighted combine: h [B*K, IN] bf16, ids and wts [B, K]
// (int64, f32), w2 [E, OUT, IN/2], sz2 [E, OUT, IN/gs], ws [B*K, OUT] f32
// (workspace), out [B, OUT] bf16; arrive [ceil(OUT / 32)] int, zero before
// and after.
extern "C" int moe_down(const void* h, const void* ids, const void* wts, const void* w,
                        const void* sz, void* ws, void* out, void* arrive, int B, int K, int E,
                        int IN, int OUT, int gs, void* stream) {
  if (B < 1 || B > kMaxRows || K < 1 || B * K > kMaxPairs || E < 1 || E > kMaxExperts ||
      IN % 32 || IN > kMaxIn || gs % 32 || IN % gs)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((OUT + kCols - 1) / kCols, min(E, B * K));
  moe_w4a8_gemv_kernel<1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const int64_t*)ids, (const float*)wts, (const uint8_t*)w,
      (const uint32_t*)sz, nullptr, (float*)ws, (__nv_bfloat16*)out, (int*)arrive, nullptr, B, K,
      E, IN, OUT, gs);
  return (int)cudaGetLastError();
}

// Columns per CTA tile (the arrive buffer's length is ceil(OUT / this)).
extern "C" int moe_tile_cols() { return kCols; }
