// Single-query GQA decode attention over a bf16 or affine-quantized KV cache.
//
// Replaces the TPU kernels of cold_compress_tpu/ops/pallas_decode_attn.py::
// quantized_decode_attention, all of which compute one contract (the i8dot
// variants excepted):
//   - the one-shot `_kernel` at bits 16/8/4/2, need_attn True or False;
//   - the chunked online-softmax kernels `_kernel_chunked(_ms)` and
//     `_chunk_step`, the manual double-buffered `_kernel_manual` and the slim
//     `_kernel_v2`, which serve caches above the one-shot VMEM budget.
// One split-C kernel serves every cache length here, so it follows the
// one-shot numerics at every C:
//   k = bf16(u * s + z'), z' = z - 2^(BITS-1) * s   (BITS 8/4/2; no FMA)
//   k = the stored bf16 value                        (BITS 16)
//   scores = (q_bf16 . k) in f32 * 1/sqrt(D); masked slots -> -1e30
//   probs = softmax in f32; pooled[c] = (sum_g probs[g][c]) * (1/G)
//   out = sum_c bf16(probs[g][c]) * v in f32
// The TPU's chunked kernel rounds the unnormalised e (not p) to bf16 before
// P.V; the difference is bounded in the tests.
//
// Storage: BITS 16 holds bf16 rows of D values. BITS 8 holds one byte per
// value. BITS 4/2 use the segment packing of caches/base.py::_pack_last:
// byte j, bit range s*BITS, holds column j + s*D/per (per = 8/BITS), as the
// TPU's `_dequant_segs` unpacks it.
//
// Bound on this card: bytes (K and V of every KV head, 2*C*D*BITS/8 bytes,
// plus the per-slot scale/zero/mask). At batch 1 there are only KVH heads,
// so the cache is split over C into chunks of kChunk slots, one block each
// (128 blocks at C = 2048, KVH = 8), and every warp issues all its loads
// before it uses them. Three launches on the caller's stream:
//   1. scores: each block dequantizes its chunk's K rows (8 lanes per row,
//      16 values per lane), writes the G heads' scores to a workspace and the
//      chunk's softmax statistics (max m_s, sum l_s of exp(score - m_s));
//   2. probabilities and P.V: each block folds every chunk's (m_s, l_s) into
//      the head's final (m, l) in a fixed order (one warp per query head),
//      normalises its chunk's scores as a one-pass softmax does
//      (exp(s - m) / l), writes the pooled probabilities when NEED_ATTN,
//      rounds them to bf16 and multiplies them with its V rows into a
//      partial output;
//   3. reduce: the partial outputs are summed over the chunks in order.
// Every sum has a fixed order (no atomics), so the result is deterministic.
// The workspace (scores, statistics, partials) is sized per call by
// decode_attention_workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kMaxG = 8;
constexpr int kChunk = 128;                          // cache slots per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerLane = kChunk / (kWarps * 4);  // scores: 4 rows per warp step
constexpr int kSlotsPerWarp = kChunk / kWarps;       // P.V
constexpr int kQStride = kD + kD / 16;               // query row stride: one pad per 16
constexpr float kNegInf = -1e30f;

// Row layout of one cache format.
template <int BITS>
struct Fmt {
  static constexpr int kPer = BITS >= 8 ? 1 : 8 / BITS;  // values per byte
  static constexpr int kRowBytes = BITS == 16 ? kD * 2 : kD * BITS / 8;
  static constexpr int kSeg = kD / kPer;                // columns per bit range
  // scores: 8 lanes per row, 16 values each
  static constexpr int kLaneBytes = kRowBytes / 8;
  static constexpr int kLaneWords = kLaneBytes / 4;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float deq_bf16(uint32_t u, float s, float zp) {
  // Separate mul and add (no fma contraction) to round exactly as the
  // plain version does, then round to bf16.
  return bf16_round(__fadd_rn(__fmul_rn((float)u, s), zp));
}

template <int BITS>
__device__ __forceinline__ float folded_zero(float z, float s) {
  return __fsub_rn(z, __fmul_rn((float)(1 << (BITS - 1)), s));
}

// N 32-bit words from a 4*N-byte aligned address, in as few loads as the
// alignment allows.
template <int N>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t* w) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k);
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
}

// Value i (0..15) of a scores lane: its column and its dequantized value.
// BITS 16: halfword i of the lane's 32 bytes, column lane8*16 + i.
// BITS 8/4/2: byte b = i % kLaneBytes, bit range seg = i / kLaneBytes,
// column lane8*kLaneBytes + b + seg*kSeg.
template <int BITS>
__device__ __forceinline__ int score_col(int lane8, int i) {
  using F = Fmt<BITS>;
  if constexpr (BITS == 16) {
    return lane8 * 16 + i;
  } else {
    return lane8 * F::kLaneBytes + (i % F::kLaneBytes) + (i / F::kLaneBytes) * F::kSeg;
  }
}

template <int BITS>
__device__ __forceinline__ float score_val(const uint32_t* w, int i, float s, float zp) {
  using F = Fmt<BITS>;
  if constexpr (BITS == 16) {
    const uint32_t h = (w[i >> 1] >> (16 * (i & 1))) & 0xFFFFu;
    return __uint_as_float(h << 16);
  } else {
    const int b = i % F::kLaneBytes, seg = i / F::kLaneBytes;
    const uint32_t byte = (w[b >> 2] >> (8 * (b & 3))) & 0xFFu;
    const uint32_t u = BITS == 8 ? byte : (byte >> (BITS * seg)) & ((1u << BITS) - 1u);
    return deq_bf16(u, s, zp);
  }
}

struct Workspace {
  float* scores;  // [B, KVH, G, C]
  float* stats;   // [B, KVH, nsplit, G, 2]: (m_s, l_s)
  float* part;    // [B, KVH, nsplit, G, kD]
};

inline size_t workspace_floats(int B, int KVH, int C, int G, int nsplit,
                               Workspace* ws, float* base) {
  const size_t heads = (size_t)B * KVH;
  const size_t n_scores = heads * G * C;
  const size_t n_stats = heads * nsplit * G * 2;
  const size_t n_part = heads * nsplit * G * kD;
  if (ws) {
    ws->scores = base;
    ws->stats = base + n_scores;
    ws->part = base + n_scores + n_stats;
  }
  return n_scores + n_stats + n_part;
}

// ---- 1. scores and per-chunk softmax statistics ----
template <int BITS>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const __nv_bfloat16* __restrict__ q,  // [B, H, D]
              const uint8_t* __restrict__ kc,       // [B, KVH, C, row bytes]
              const float* __restrict__ ks, const float* __restrict__ kz,
              const uint8_t* __restrict__ mask,     // [B, KVH, C]
              Workspace ws, int KVH, int C, int G, float scale) {
  using F = Fmt<BITS>;
  __shared__ float qs[kMaxG][kQStride];
  __shared__ float sc[kMaxG][kChunk];
  __shared__ float redm[kWarps][kMaxG];
  __shared__ float redl[kWarps][kMaxG];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = (size_t)b * KVH + h;
  const int c0 = split * kChunk;
  const int n = min(kChunk, C - c0);

  // 8 lanes per cache row; a warp step covers 4 rows. Issue this lane's
  // loads first.
  const int sub = lane >> 3, lane8 = lane & 7;
  uint32_t raw[kRowsPerLane][F::kLaneWords];
  float srow[kRowsPerLane], zrow[kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    const int r = i * kWarps * 4 + warp * 4 + sub;
    srow[i] = zrow[i] = 0.f;
#pragma unroll
    for (int k = 0; k < F::kLaneWords; ++k) raw[i][k] = 0u;
    if (r < n) {
      const size_t c = bh * C + c0 + r;
      load_words<F::kLaneWords>(kc + c * F::kRowBytes + lane8 * F::kLaneBytes, raw[i]);
      if constexpr (BITS != 16) {
        srow[i] = ks[c];
        zrow[i] = kz[c];
      }
    }
  }
  for (int i = tid; i < G * kD; i += kThreads) {
    const int g = i / kD, d = i % kD;
    qs[g][d + (d >> 4)] = __bfloat162float(q[bh * G * kD + i]);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    const int r = i * kWarps * 4 + warp * 4 + sub;
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    const float zp = BITS == 16 ? 0.f : folded_zero<BITS == 16 ? 8 : BITS>(zrow[i], srow[i]);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float kv = score_val<BITS>(raw[i], j, srow[i], zp);
      const int d = score_col<BITS>(lane8, j);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = fmaf(qs[g][d + (d >> 4)], kv, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float v = acc[g];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (lane8 == 0 && r < n) sc[g][r] = mask[bh * C + c0 + r] ? v * scale : kNegInf;
    }
  }
  __syncthreads();

  // Chunk max per head, then the sum of exp(score - max); thread t < n owns
  // slot t of the chunk.
  const bool own = tid < n;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    float v = own ? sc[g][tid] : kNegInf;
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) redm[warp][g] = v;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    float m = redm[0][g];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, redm[w][g]);
    float v = own ? expf(sc[g][tid] - m) : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) redl[warp][g] = v;
    if (own) ws.scores[(bh * G + g) * C + c0 + tid] = sc[g][tid];
  }
  __syncthreads();
  if (tid < G) {
    float m = redm[0][tid], l = 0.f;
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, redm[w][tid]);
    for (int w = 0; w < kWarps; ++w) l += redl[w][tid];
    float* st = ws.stats + ((bh * nsplit + split) * G + tid) * 2;
    st[0] = m;
    st[1] = l;
  }
}

// ---- 2. final (m, l), probabilities, pooled mean, partial P.V ----
// Each lane owns 4 output columns, lane*4 .. lane*4 + 3.
template <int BITS, bool NEED_ATTN>
__global__ void __launch_bounds__(kThreads)
pv_kernel(const uint8_t* __restrict__ vc,  // [B, KVH, C, row bytes]
          const float* __restrict__ vs, const float* __restrict__ vz,
          float* __restrict__ pooled,      // [B, KVH, C]
          Workspace ws, int KVH, int C, int G) {
  using F = Fmt<BITS>;
  constexpr int kLoadWords = BITS == 16 ? 2 : 1;
  __shared__ float fin[2][kMaxG];  // final m and l per head
  __shared__ float ps[kMaxG][kChunk];
  __shared__ float red[kWarps][kMaxG][kD];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = (size_t)b * KVH + h;
  const int c0 = split * kChunk;
  const int n = min(kChunk, C - c0);
  // This lane's bytes within a row and, for packed rows, its bit range.
  const int byte0 = BITS == 16 ? lane * 8 : (lane * 4) % F::kRowBytes;
  const int seg = BITS >= 8 ? 0 : (lane * 4) / F::kSeg;

  // This warp's V rows (slots warp, warp + kWarps, ...), loaded before
  // anything waits on them.
  uint32_t raw[kSlotsPerWarp][kLoadWords];
  float srow[kSlotsPerWarp], zrow[kSlotsPerWarp];
#pragma unroll
  for (int u = 0; u < kSlotsPerWarp; ++u) {
    const int t = warp + u * kWarps;
#pragma unroll
    for (int k = 0; k < kLoadWords; ++k) raw[u][k] = 0u;
    srow[u] = zrow[u] = 0.f;
    if (t < n) {
      const size_t c = bh * C + c0 + t;
      load_words<kLoadWords>(vc + c * F::kRowBytes + byte0, raw[u]);
      if constexpr (BITS != 16) {
        srow[u] = vs[c];
        zrow[u] = vz[c];
      }
    }
  }

  // Final (m, l) of query head g = warp, over every chunk, lanes striding
  // the chunks; the shuffle tree fixes the order.
  if (warp < G) {
    const float* st = ws.stats + bh * nsplit * G * 2;
    float m = kNegInf;
    for (int s = lane; s < nsplit; s += 32) m = fmaxf(m, st[(s * G + warp) * 2]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int s = lane; s < nsplit; s += 32)
      l += st[(s * G + warp) * 2 + 1] * expf(st[(s * G + warp) * 2] - m);
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      fin[0][warp] = m;
      fin[1][warp] = l;
    }
  }
  __syncthreads();

  if (tid < n) {
    const int c = c0 + tid;
    float psum = 0.f;
    for (int g = 0; g < G; ++g) {
      const float e = expf(ws.scores[(bh * G + g) * C + c] - fin[0][g]);
      const float p = __fdiv_rn(e, fin[1][g]);
      ps[g][tid] = p;
      psum += p;
    }
    if constexpr (NEED_ATTN) pooled[bh * C + c] = psum * (1.0f / (float)G);
  }
  __syncthreads();

  float acc[kMaxG][4];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;
#pragma unroll
  for (int u = 0; u < kSlotsPerWarp; ++u) {
    const int t = warp + u * kWarps;
    if (t >= n) break;  // uniform across the warp
    float vv[4];
    if constexpr (BITS == 16) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        vv[j] = __uint_as_float(((raw[u][j >> 1] >> (16 * (j & 1))) & 0xFFFFu) << 16);
    } else {
      const float zp = folded_zero<BITS == 16 ? 8 : BITS>(zrow[u], srow[u]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t byte = (raw[u][0] >> (8 * j)) & 0xFFu;
        const uint32_t q = BITS == 8 ? byte : (byte >> (BITS * seg)) & ((1u << BITS) - 1u);
        vv[j] = deq_bf16(q, srow[u], zp);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float p = bf16_round(ps[g][t]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][j] = fmaf(p, vv[j], acc[g][j]);
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][g][lane * 4 + j] = acc[g][j];
  }
  __syncthreads();
  float* part = ws.part + (bh * nsplit + split) * G * kD;
  for (int i = tid; i < G * kD; i += kThreads) {
    const int g = i / kD, d = i % kD;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w][g][d];
    part[i] = s;
  }
}

// ---- 3. sum of the partial outputs over the chunks, in order ----
__global__ void reduce_kernel(Workspace ws, float* __restrict__ out,  // [B, H, D]
                              int KVH, int G, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * KVH + h;
  const int i = threadIdx.x;  // g * kD + d, one block of G * kD threads
  const float* part = ws.part + bh * nsplit * G * kD;
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) s += part[(size_t)sp * G * kD + i];
  out[bh * G * kD + i] = s;
}

template <int BITS, bool NEED_ATTN>
int launch(const void* q, const void* kc, const void* vc, const void* ks, const void* kz,
           const void* vs, const void* vz, const void* mask, void* out, void* pooled,
           void* workspace, int B, int KVH, int C, int G, float scale, cudaStream_t st) {
  const int nsplit = (C + kChunk - 1) / kChunk;
  Workspace ws;
  workspace_floats(B, KVH, C, G, nsplit, &ws, (float*)workspace);
  const dim3 grid(nsplit, KVH, B);
  scores_kernel<BITS><<<grid, kThreads, 0, st>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)kc, (const float*)ks, (const float*)kz,
      (const uint8_t*)mask, ws, KVH, C, G, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pv_kernel<BITS, NEED_ATTN><<<grid, kThreads, 0, st>>>(
      (const uint8_t*)vc, (const float*)vs, (const float*)vz, (float*)pooled, ws, KVH, C, G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<dim3(KVH, B), G * kD, 0, st>>>(ws, (float*)out, KVH, G, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of workspace that decode_attention needs for these shapes.
extern "C" size_t decode_attention_workspace(int B, int KVH, int C, int G) {
  const int nsplit = (C + kChunk - 1) / kChunk;
  return workspace_floats(B, KVH, C, G, nsplit, nullptr, nullptr);
}

// bits: 16 (bf16 rows; scale/zero pointers unused), 8, 4 or 2.
// need_attn: write pooled [B, KVH, C] (else pooled is unused).
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* ks, const void* kz, const void* vs,
                                const void* vz, const void* mask, void* out, void* pooled,
                                void* workspace, int B, int KVH, int C, int G, int bits,
                                int need_attn, float scale, void* stream) {
  if (G < 1 || G > kMaxG || C < 1 || B < 1 || KVH < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define CCT_DECODE_CASE(BITS_)                                                              \
  case BITS_:                                                                               \
    return need_attn ? launch<BITS_, true>(q, kc, vc, ks, kz, vs, vz, mask, out, pooled,    \
                                           workspace, B, KVH, C, G, scale, st)              \
                     : launch<BITS_, false>(q, kc, vc, ks, kz, vs, vz, mask, out, pooled,   \
                                            workspace, B, KVH, C, G, scale, st);
  switch (bits) {
    CCT_DECODE_CASE(16)
    CCT_DECODE_CASE(8)
    CCT_DECODE_CASE(4)
    CCT_DECODE_CASE(2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CCT_DECODE_CASE
}
