// Causal GQA flash attention over a padded prompt, with per-key summaries.
//
// Replaces the TPU kernel cold_compress_tpu/ops/pallas_prefill.py::
// flash_prefill (`_kernel`). The G query heads of a KV head are folded into
// the query rows (row r = position r / G, head r % G), so K and V are never
// repeated.
//
// Pass 1 (flash_fwd_kernel): one block per (64 folded rows, KV head, batch).
//   bf16 operands on the tensor cores (mma.sync m16n8k16, f32 accumulate),
//   online softmax in f32 over 64-key tiles held in shared memory, p cast to
//   bf16 before P.V, y = acc / l in bf16. Writes each row's final softmax
//   statistics (m, l) to a small [B, KVH, P*G] f32 buffer.
// Pass 2 (flash_colsum_kernel): one block per (64-key block, KV head,
//   batch). It loops over the query rows at or after its keys (and before
//   prompt_len), recomputes the scores, normalises them with (m, l), and
//   sums them per key weighted by validity / G (cum) and by the last
//   obs_len positions / G (obs). Each key's sums are written once by the
//   block that owns it: no atomics, so the result is deterministic. (The
//   TPU kernel accumulated across sequential grid steps, which Hopper's
//   parallel blocks cannot do.)
//
// A second entry point, flash_profile, replaces pallas_prefill.py::
// flash_profile: the same pass 1, then pass 2 (flash_profile_colsum_kernel)
// sums the same probabilities into the FastGen hybrid profile: cum (every
// valid row) and, for up to four recent-window lengths w, the rows whose
// window holds the key (c <= pos <= c + w - 1). The window sums ride on the
// loop cum already needs, which visits every row at or after the key.
//
// Bound on this card: operations. At P = 8192, head_dim 128 the causal
// products are ~0.55 TFLOP per layer (QK^T + PV), plus the pass-2
// recompute of QK^T; the inputs are ~100 MB. The design puts the products on
// the bf16 tensor cores with register-resident query fragments; copies are
// plain (no cp.async/TMA pipelining yet) and tiles are padded by 8 columns
// so fragment loads from shared memory are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kBR = 64;           // folded query rows per block (4 warps x 16)
constexpr int kBK = 64;           // keys per tile
constexpr int kStride = kD + 8;   // shared-memory row stride in bf16
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of folded row r of (b, kvh) in a [B, H, P, D] tensor.
__device__ __forceinline__ size_t qrow_offset(int b, int kvh, int r, int H,
                                              int G, int P) {
  return (((size_t)b * H + (size_t)kvh * G + (r % G)) * P + r / G) * kD;
}

__device__ __forceinline__ void load_q_tile(__nv_bfloat16* dst,
                                            const __nv_bfloat16* __restrict__ q,
                                            int b, int kvh, int r0, int H,
                                            int G, int P) {
  const int nrows = P * G;
  for (int idx = threadIdx.x; idx < kBR * (kD / 8); idx += kThreads) {
    const int row = idx >> 4, ch = idx & 15;
    const int r = r0 + row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows)
      v = *reinterpret_cast<const uint4*>(q + qrow_offset(b, kvh, r, H, G, P) + ch * 8);
    *reinterpret_cast<uint4*>(dst + row * kStride + ch * 8) = v;
  }
}

__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* __restrict__ src) {
  for (int idx = threadIdx.x; idx < kBK * (kD / 8); idx += kThreads) {
    const int row = idx >> 4, ch = idx & 15;
    *reinterpret_cast<uint4*>(dst + row * kStride + ch * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)row * kD + ch * 8);
  }
}

// A fragments of this warp's 16 query rows, all 8 k-steps of D = 128.
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[8][4],
                                             const __nv_bfloat16* Qs, int warp,
                                             int gid, int tig) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const __nv_bfloat16* p = Qs + (warp * 16 + gid) * kStride + ks * 16 + tig * 2;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(p);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride + 8);
  }
}

// s[nt] = Q(16 rows) . K(keys nt*8 .. nt*8+7)^T, unscaled, f32.
__device__ __forceinline__ void warp_scores(float (&s)[8][4],
                                            const uint32_t (&qa)[8][4],
                                            const __nv_bfloat16* Ks, int gid,
                                            int tig) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* kr = Ks + (nt * 8 + gid) * kStride + ks * 16 + tig * 2;
      mma_bf16(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ mbuf,
                 float* __restrict__ lbuf, int H, int KVH, int P, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBR * kStride;
  __nv_bfloat16* Vs = Ks + kBK * kStride;
  const unsigned short* Vu = reinterpret_cast<const unsigned short*>(Vs);

  const int G = H / KVH;
  const int r0 = blockIdx.x * kBR, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nrows = P * G;
  const size_t bh = (size_t)b * KVH + kvh;

  load_q_tile(Qs, q, b, kvh, r0, H, G, P);
  __syncthreads();
  uint32_t qa[8][4];
  load_q_frags(qa, Qs, warp, gid, tig);

  const int rowA = r0 + warp * 16 + gid, rowB = rowA + 8;
  const int posA = rowA / G, posB = rowB / G;
  const int last_pos = min(r0 + kBR - 1, nrows - 1) / G;
  const int n_kb = last_pos / kBK + 1;
  const __nv_bfloat16* Kb = k + bh * (size_t)P * kD;
  const __nv_bfloat16* Vb = v + bh * (size_t)P * kD;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[16][4];
#pragma unroll
  for (int dt = 0; dt < 16; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[dt][j] = 0.f;

  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    load_kv_tile(Ks, Kb + (size_t)kb * kBK * kD);
    load_kv_tile(Vs, Vb + (size_t)kb * kBK * kD);
    __syncthreads();

    float s[8][4];
    warp_scores(s, qa, Ks, gid, tig);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = kb * kBK + nt * 8 + tig * 2 + j;
        s[nt][j] = col <= posA ? s[nt][j] * scale : kNegInf;
        s[nt][2 + j] = col <= posB ? s[nt][2 + j] * scale : kNegInf;
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float a0 = expf(m[0] - mn0), a1 = expf(m[1] - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = expf(s[nt][j] - mn0);
        s[nt][2 + j] = expf(s[nt][2 + j] - mn1);
        sum0 += s[nt][j];
        sum1 += s[nt][2 + j];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l[0] = l[0] * a0 + sum0;
    l[1] = l[1] * a1 + sum1;
    m[0] = mn0;
    m[1] = mn1;
#pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const int key = kk * 16 + tig * 2;
#pragma unroll
      for (int dt = 0; dt < 16; ++dt) {
        const int d = dt * 8 + gid;
        const uint32_t b0 = (uint32_t)Vu[key * kStride + d] |
                            ((uint32_t)Vu[(key + 1) * kStride + d] << 16);
        const uint32_t b1 = (uint32_t)Vu[(key + 8) * kStride + d] |
                            ((uint32_t)Vu[(key + 9) * kStride + d] << 16);
        mma_bf16(o[dt], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h == 0 ? rowA : rowB;
    if (r >= nrows) continue;
    __nv_bfloat16* yr = y + qrow_offset(b, kvh, r, H, G, P);
#pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      const float v0 = __fdiv_rn(o[dt][2 * h], l[h]);
      const float v1 = __fdiv_rn(o[dt][2 * h + 1], l[h]);
      *reinterpret_cast<uint32_t*>(yr + dt * 8 + tig * 2) = pack_bf16(v0, v1);
    }
    if (tig == 0) {
      mbuf[bh * nrows + r] = m[h];
      lbuf[bh * nrows + r] = l[h];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_colsum_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const float* __restrict__ mbuf,
                    const float* __restrict__ lbuf,
                    const int* __restrict__ plen_arr, float* __restrict__ cum,
                    float* __restrict__ obs, int H, int KVH, int P, float scale,
                    int obs_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBR * kStride;
  float* ms = reinterpret_cast<float*>(Ks + kBK * kStride);  // [kBR]
  float* ils = ms + kBR;                                      // [kBR] 1 / l
  float* red = ils + kBR;                                     // [2][4][kBK]

  const int G = H / KVH;
  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nrows = P * G;
  const size_t bh = (size_t)b * KVH + kvh;
  const int key0 = kb * kBK;
  const int plen = plen_arr[b];

  if (key0 >= plen) {  // keys no valid query sees: sums are zero
    for (int t = threadIdx.x; t < kBK; t += kThreads) {
      cum[bh * P + key0 + t] = 0.f;
      obs[bh * P + key0 + t] = 0.f;
    }
    return;
  }
  load_kv_tile(Ks, k + (bh * P + key0) * kD);
  const float wg = 1.0f / (float)G;

  float cc[8][2], co[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) cc[nt][j] = co[nt][j] = 0.f;

  const int row_end = min(plen, P) * G;
  for (int r0 = key0 * G; r0 < row_end; r0 += kBR) {
    __syncthreads();
    load_q_tile(Qs, q, b, kvh, r0, H, G, P);
    for (int t = threadIdx.x; t < kBR; t += kThreads) {
      const int r = r0 + t;
      ms[t] = r < nrows ? mbuf[bh * nrows + r] : 0.f;
      ils[t] = r < nrows ? __fdiv_rn(1.0f, lbuf[bh * nrows + r]) : 0.f;
    }
    __syncthreads();
    uint32_t qa[8][4];
    load_q_frags(qa, Qs, warp, gid, tig);
    float s[8][4];
    warp_scores(s, qa, Ks, gid, tig);

    const int ra = warp * 16 + gid, rb = ra + 8;
    const int posA = (r0 + ra) / G, posB = (r0 + rb) / G;
    const float wcA = posA < plen ? wg : 0.f, wcB = posB < plen ? wg : 0.f;
    const float woA = (posA >= plen - obs_len && posA < plen) ? wg : 0.f;
    const float woB = (posB >= plen - obs_len && posB < plen) ? wg : 0.f;
    const float mA = ms[ra], mB = ms[rb], ilA = ils[ra], ilB = ils[rb];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = key0 + nt * 8 + tig * 2 + j;
        const float pA = col <= posA ? expf(s[nt][j] * scale - mA) * ilA : 0.f;
        const float pB = col <= posB ? expf(s[nt][2 + j] * scale - mB) * ilB : 0.f;
        cc[nt][j] += wcA * pA + wcB * pB;
        co[nt][j] += woA * pA + woB * pB;
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float vc = cc[nt][j], vo = co[nt][j];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        vc += __shfl_xor_sync(0xffffffffu, vc, off);
        vo += __shfl_xor_sync(0xffffffffu, vo, off);
      }
      if (gid == 0) {
        red[(0 * 4 + warp) * kBK + nt * 8 + tig * 2 + j] = vc;
        red[(1 * 4 + warp) * kBK + nt * 8 + tig * 2 + j] = vo;
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kBK; t += kThreads) {
    float sc = 0.f, so = 0.f;
    for (int w = 0; w < 4; ++w) {
      sc += red[(0 * 4 + w) * kBK + t];
      so += red[(1 * 4 + w) * kBK + t];
    }
    cum[bh * P + key0 + t] = sc;
    obs[bh * P + key0 + t] = so;
  }
}

// Pass 2 of flash_profile: the FastGen profile accumulators. The same block
// per (64-key block, KV head, batch) and the same recomputed, normalised
// probabilities as flash_colsum_kernel. cum sums them over every valid query
// row (weight 1 / G); wcols[wi] sums only the rows whose recent window of
// length win[wi] holds the key: c <= pos <= c + win - 1 (and pos <
// prompt_len). Raw sums, no division by the number of queries.
template <int NW>
__global__ void __launch_bounds__(kThreads)
flash_profile_colsum_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const float* __restrict__ mbuf,
                            const float* __restrict__ lbuf,
                            const int* __restrict__ plen_arr,
                            float* __restrict__ cum, float* __restrict__ wcols,
                            int4 win, int B, int H, int KVH, int P, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBR * kStride;
  float* ms = reinterpret_cast<float*>(Ks + kBK * kStride);  // [kBR]
  float* ils = ms + kBR;                                      // [kBR] 1 / l
  float* red = ils + kBR;                                     // [1 + NW][4][kBK]

  const int G = H / KVH;
  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nrows = P * G;
  const size_t bh = (size_t)b * KVH + kvh;
  const size_t wstride = (size_t)B * KVH * P;  // one window's [B, KVH, P]
  const int key0 = kb * kBK;
  const int plen = plen_arr[b];
  const int wl[4] = {win.x, win.y, win.z, win.w};

  if (key0 >= plen) {  // keys no valid query sees: sums are zero
    for (int t = threadIdx.x; t < kBK; t += kThreads) {
      cum[bh * P + key0 + t] = 0.f;
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) wcols[wi * wstride + bh * P + key0 + t] = 0.f;
    }
    return;
  }
  load_kv_tile(Ks, k + (bh * P + key0) * kD);
  const float wg = 1.0f / (float)G;

  float cc[8][2], cw[NW > 0 ? NW : 1][8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      cc[nt][j] = 0.f;
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) cw[wi][nt][j] = 0.f;
    }

  const int row_end = min(plen, P) * G;
  for (int r0 = key0 * G; r0 < row_end; r0 += kBR) {
    __syncthreads();
    load_q_tile(Qs, q, b, kvh, r0, H, G, P);
    for (int t = threadIdx.x; t < kBR; t += kThreads) {
      const int r = r0 + t;
      ms[t] = r < nrows ? mbuf[bh * nrows + r] : 0.f;
      ils[t] = r < nrows ? __fdiv_rn(1.0f, lbuf[bh * nrows + r]) : 0.f;
    }
    __syncthreads();
    uint32_t qa[8][4];
    load_q_frags(qa, Qs, warp, gid, tig);
    float s[8][4];
    warp_scores(s, qa, Ks, gid, tig);

    const int ra = warp * 16 + gid, rb = ra + 8;
    const int posA = (r0 + ra) / G, posB = (r0 + rb) / G;
    const float wcA = posA < plen ? wg : 0.f, wcB = posB < plen ? wg : 0.f;
    const float mA = ms[ra], mB = ms[rb], ilA = ils[ra], ilB = ils[rb];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = key0 + nt * 8 + tig * 2 + j;
        const float pA = col <= posA ? wcA * (expf(s[nt][j] * scale - mA) * ilA) : 0.f;
        const float pB = col <= posB ? wcB * (expf(s[nt][2 + j] * scale - mB) * ilB) : 0.f;
        cc[nt][j] += pA + pB;
#pragma unroll
        for (int wi = 0; wi < NW; ++wi)
          cw[wi][nt][j] += (posA - col < wl[wi] ? pA : 0.f) + (posB - col < wl[wi] ? pB : 0.f);
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float vals[1 + NW];
      vals[0] = cc[nt][j];
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) vals[1 + wi] = cw[wi][nt][j];
#pragma unroll
      for (int a = 0; a < 1 + NW; ++a) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          vals[a] += __shfl_xor_sync(0xffffffffu, vals[a], off);
        if (gid == 0) red[(a * 4 + warp) * kBK + nt * 8 + tig * 2 + j] = vals[a];
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kBK; t += kThreads) {
#pragma unroll
    for (int a = 0; a < 1 + NW; ++a) {
      float sum = 0.f;
      for (int w = 0; w < 4; ++w) sum += red[(a * 4 + w) * kBK + t];
      if (a == 0)
        cum[bh * P + key0 + t] = sum;
      else
        wcols[(a - 1) * wstride + bh * P + key0 + t] = sum;
    }
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Pass 1 of both entry points: y and each folded row's (m, l).
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* y, void* mbuf,
                       void* lbuf, int B, int H, int KVH, int P, float scale,
                       cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem = (size_t)(kBR + 2 * kBK) * kStride * sizeof(__nv_bfloat16);
  cudaError_t e = set_smem((const void*)flash_fwd_kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((P * G + kBR - 1) / kBR, KVH, B);
  flash_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)y, (float*)mbuf, (float*)lbuf, H, KVH, P, scale);
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch_profile_colsum(const void* q, const void* k, const void* mbuf,
                                  const void* lbuf, const void* plen, void* cum,
                                  void* wcols, int4 win, int B, int H, int KVH, int P,
                                  float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(kBR + kBK) * kStride * sizeof(__nv_bfloat16) +
                      (2 * kBR + (1 + NW) * 4 * kBK) * sizeof(float);
  cudaError_t e = set_smem((const void*)flash_profile_colsum_kernel<NW>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(P / kBK, KVH, B);
  flash_profile_colsum_kernel<NW><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const float*)mbuf,
      (const float*)lbuf, (const int*)plen, (float*)cum, (float*)wcols, win, B, H, KVH,
      P, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_prefill_summary(const void* q, const void* k, const void* v,
                                     void* y, void* mbuf, void* lbuf,
                                     const void* plen, void* cum, void* obs,
                                     int B, int H, int KVH, int P, float scale,
                                     int obs_len, int need_summary, void* stream) {
  cudaError_t e = launch_fwd(q, k, v, y, mbuf, lbuf, B, H, KVH, P, scale,
                             (cudaStream_t)stream);
  if (e != cudaSuccess || !need_summary) return (int)e;
  const size_t smem2 = (size_t)(kBR + kBK) * kStride * sizeof(__nv_bfloat16) +
                       (2 * kBR + 2 * 4 * kBK) * sizeof(float);
  e = set_smem((const void*)flash_colsum_kernel, smem2);
  if (e != cudaSuccess) return (int)e;
  dim3 grid2(P / kBK, KVH, B);
  flash_colsum_kernel<<<grid2, kThreads, smem2, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const float*)mbuf,
      (const float*)lbuf, (const int*)plen, (float*)cum, (float*)obs, H, KVH, P,
      scale, obs_len);
  return (int)cudaGetLastError();
}

// Attention plus the FastGen profile (flash_profile): pass 1 as above, then
// cum [B, KVH, P] and wcols [n_windows, B, KVH, P] for up to four distinct
// window lengths w0..w3.
extern "C" int flash_profile(const void* q, const void* k, const void* v, void* y,
                             void* mbuf, void* lbuf, const void* plen, void* cum,
                             void* wcols, int B, int H, int KVH, int P, float scale,
                             int n_windows, int w0, int w1, int w2, int w3, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = launch_fwd(q, k, v, y, mbuf, lbuf, B, H, KVH, P, scale, s);
  if (e != cudaSuccess) return (int)e;
  const int4 win = make_int4(w0, w1, w2, w3);
  switch (n_windows) {
    case 0: return (int)launch_profile_colsum<0>(q, k, mbuf, lbuf, plen, cum, wcols, win,
                                                 B, H, KVH, P, scale, s);
    case 1: return (int)launch_profile_colsum<1>(q, k, mbuf, lbuf, plen, cum, wcols, win,
                                                 B, H, KVH, P, scale, s);
    case 2: return (int)launch_profile_colsum<2>(q, k, mbuf, lbuf, plen, cum, wcols, win,
                                                 B, H, KVH, P, scale, s);
    case 3: return (int)launch_profile_colsum<3>(q, k, mbuf, lbuf, plen, cum, wcols, win,
                                                 B, H, KVH, P, scale, s);
    case 4: return (int)launch_profile_colsum<4>(q, k, mbuf, lbuf, plen, cum, wcols, win,
                                                 B, H, KVH, P, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
