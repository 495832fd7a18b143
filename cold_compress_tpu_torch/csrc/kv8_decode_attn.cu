// Single-query GQA decode attention over a uint8 affine KV cache.
//
// Replaces the TPU kernel cold_compress_tpu/ops/pallas_decode_attn.py::
// quantized_decode_attention (one-shot `_kernel`, bits=8, need_attn=True,
// the i8dot=False branch):
//   k = bf16(u8 * s + z'), z' = z - 128 * s    (dequant rounded to bf16)
//   scores = (q_bf16 . k) in f32 * 1/sqrt(D); masked slots -> -1e30
//   probs = softmax in f32; pooled[c] = (sum_g probs[g][c]) * (1/G)
//   out = sum_c bf16(probs[g][c]) * bf16(u8 * s_v + z_v') in f32
// The TPU's i8dot variant (int8 query and probabilities on the MXU) is a
// TPU-specific option and is not ported here.
//
// Bound on this card: bytes (K and V, 2*C*D bytes per KV head, plus the
// per-slot scale/zero/mask). At batch 1 there are only KVH heads, so the
// cache is split over C into chunks of kChunk slots, one block each (128
// blocks at C = 2048, KVH = 8), and every warp issues all its loads before
// it uses them. The work runs as three launches on the caller's stream:
//   1. scores: each block dequantizes its chunk's K rows (16-byte loads, 8
//      lanes per row), writes the G heads' scores to a workspace and the
//      chunk's softmax statistics (max m_s, sum l_s of exp(score - m_s));
//   2. probabilities and P.V: each block combines every chunk's (m_s, l_s)
//      into the head's final (m, l) in a fixed order, normalises its
//      chunk's scores as a one-pass softmax does (exp(s - m) / l), writes
//      the pooled probabilities, rounds them to bf16 and multiplies them
//      with its dequantized V rows into a partial output;
//   3. reduce: the partial outputs are summed over the chunks in order.
// Every sum has a fixed order (no atomics), so the result is deterministic,
// and the pooled probabilities are normalised with the final (m, l).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kMaxG = 8;
constexpr int kChunk = 128;                       // cache slots per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerLane = kChunk / (kWarps * 4);  // scores: 4 rows per warp step
constexpr int kSlotsPerWarp = kChunk / kWarps;       // P.V
constexpr int kQStride = kD + kD / 16;            // query row stride: one pad per 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float deq_bf16(uint32_t u, float s, float zp) {
  // Separate mul and add (no fma contraction) to round exactly as the
  // plain version does, then round to bf16.
  return __bfloat162float(__float2bfloat16(__fadd_rn(__fmul_rn((float)u, s), zp)));
}

__device__ __forceinline__ float folded_zero(float z, float s) {
  return __fsub_rn(z, __fmul_rn(128.f, s));
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
__global__ void __launch_bounds__(kThreads)
kv8_scores_kernel(const __nv_bfloat16* __restrict__ q,  // [B, H, D]
                  const uint8_t* __restrict__ kq,       // [B, KVH, C, D]
                  const float* __restrict__ ks, const float* __restrict__ kz,
                  const uint8_t* __restrict__ mask,     // [B, KVH, C]
                  Workspace ws, int KVH, int C, int G, float scale) {
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

  // 8 lanes per cache row, 16 dims per lane; a warp step covers 4 rows.
  // Issue this lane's loads first.
  const int sub = lane >> 3;
  const int d0 = (lane & 7) * 16;
  uint4 raw[kRowsPerLane];
  float srow[kRowsPerLane], zrow[kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    const int r = i * kWarps * 4 + warp * 4 + sub;
    raw[i] = make_uint4(0u, 0u, 0u, 0u);
    srow[i] = zrow[i] = 0.f;
    if (r < n) {
      const size_t c = bh * C + c0 + r;
      raw[i] = __ldg(reinterpret_cast<const uint4*>(kq + c * kD + d0));
      srow[i] = ks[c];
      zrow[i] = kz[c];
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
    const float zp = folded_zero(zrow[i], srow[i]);
    const uint32_t words[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = deq_bf16((words[wi] >> (8 * j)) & 0xFFu, srow[i], zp);
        const int d = d0 + wi * 4 + j;  // d >> 4 == lane & 7: conflict-free
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] = fmaf(qs[g][d + (d >> 4)], kv, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float v = acc[g];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if ((lane & 7) == 0 && r < n)
        sc[g][r] = mask[bh * C + c0 + r] ? v * scale : kNegInf;
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
__global__ void __launch_bounds__(kThreads)
kv8_pv_kernel(const uint8_t* __restrict__ vq,  // [B, KVH, C, D]
              const float* __restrict__ vs, const float* __restrict__ vz,
              float* __restrict__ pooled,      // [B, KVH, C]
              Workspace ws, int KVH, int C, int G) {
  __shared__ float fin[2][kMaxG];  // final m and l per head
  __shared__ float ps[kMaxG][kChunk];
  __shared__ float red[kWarps][kMaxG][kD];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = (size_t)b * KVH + h;
  const int c0 = split * kChunk;
  const int n = min(kChunk, C - c0);

  // This warp's V rows (slots warp, warp + kWarps, ...), 4 dims per lane,
  // loaded before anything waits on them.
  uint32_t raw[kSlotsPerWarp];
  float srow[kSlotsPerWarp], zrow[kSlotsPerWarp];
#pragma unroll
  for (int u = 0; u < kSlotsPerWarp; ++u) {
    const int t = warp + u * kWarps;
    raw[u] = 0u;
    srow[u] = zrow[u] = 0.f;
    if (t < n) {
      const size_t c = bh * C + c0 + t;
      raw[u] = __ldg(reinterpret_cast<const uint32_t*>(vq + c * kD) + lane);
      srow[u] = vs[c];
      zrow[u] = vz[c];
    }
  }

  if (tid < G) {
    const float* st = ws.stats + bh * nsplit * G * 2;
    float m = kNegInf;
    for (int s = 0; s < nsplit; ++s) m = fmaxf(m, st[(s * G + tid) * 2]);
    float l = 0.f;
    for (int s = 0; s < nsplit; ++s)
      l += st[(s * G + tid) * 2 + 1] * expf(st[(s * G + tid) * 2] - m);
    fin[0][tid] = m;
    fin[1][tid] = l;
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
    pooled[bh * C + c] = psum * (1.0f / (float)G);
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
    const float zp = folded_zero(zrow[u], srow[u]);
    float vv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = deq_bf16((raw[u] >> (8 * j)) & 0xFFu, srow[u], zp);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float p = __bfloat162float(__float2bfloat16(ps[g][t]));
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
__global__ void kv8_reduce_kernel(Workspace ws, float* __restrict__ out,  // [B, H, D]
                                  int KVH, int G, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * KVH + h;
  const int i = threadIdx.x;  // g * kD + d, one block of G * kD threads
  const float* part = ws.part + bh * nsplit * G * kD;
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) s += part[(size_t)sp * G * kD + i];
  out[bh * G * kD + i] = s;
}

}  // namespace

// Floats of workspace that kv8_decode_attention needs for these shapes.
extern "C" size_t kv8_decode_attention_workspace(int B, int KVH, int C, int G) {
  const int nsplit = (C + kChunk - 1) / kChunk;
  return workspace_floats(B, KVH, C, G, nsplit, nullptr, nullptr);
}

extern "C" int kv8_decode_attention(const void* q, const void* kq, const void* vq,
                                    const void* ks, const void* kz, const void* vs,
                                    const void* vz, const void* mask, void* out,
                                    void* pooled, void* workspace, int B, int KVH,
                                    int C, int G, float scale, void* stream) {
  if (G < 1 || G > kMaxG || C < 1) return (int)cudaErrorInvalidValue;
  const int nsplit = (C + kChunk - 1) / kChunk;
  Workspace ws;
  workspace_floats(B, KVH, C, G, nsplit, &ws, (float*)workspace);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(nsplit, KVH, B);
  kv8_scores_kernel<<<grid, kThreads, 0, st>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)kq, (const float*)ks, (const float*)kz,
      (const uint8_t*)mask, ws, KVH, C, G, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kv8_pv_kernel<<<grid, kThreads, 0, st>>>(
      (const uint8_t*)vq, (const float*)vs, (const float*)vz, (float*)pooled, ws, KVH,
      C, G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kv8_reduce_kernel<<<dim3(KVH, B), G * kD, 0, st>>>(ws, (float*)out, KVH, G, nsplit);
  return (int)cudaGetLastError();
}
