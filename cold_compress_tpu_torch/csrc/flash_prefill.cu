// Causal GQA flash attention over a padded prompt, with per-key summaries.
//
// Replaces the TPU kernel cold_compress_tpu/ops/pallas_prefill.py::
// flash_prefill (`_kernel`). The G query heads of a KV head are folded into
// the query rows (row r = position r / G, head r % G), so K and V are never
// repeated.
//
// Pass 1 (flash_fwd_kernel): one CTA of 8 warps per (128 folded rows, KV
//   head, batch), the longest causal row blocks launched first. bf16
//   operands on the tensor cores (mma.sync m16n8k16, f32 accumulate) with
//   every fragment read by ldmatrix (V through its transposing form), K and
//   V tiles of 64 keys in a three-stage cp.async ring so that the next
//   tiles load while this one multiplies; online softmax in f32 in base 2 (log2 e
//   folded into the scale), the unnormalised e cast to bf16 before P.V as the
//   TPU kernel does, y = acc / l in bf16. Writes each row's final statistics
//   (m in base 2, 1 / l) to small [B, KVH, P*G] f32 buffers.
// Pass 2 (colsum_kernel): the per-key sums. Each work item is one 128-key
//   block (8 warps x 16 keys) against one segment of at most `seg_rows`
//   query rows (segments cut the folded rows at fixed multiples of
//   seg_rows, so no item carries more than one segment of work, whatever
//   the keys' position). It holds
//   the keys' fragments in registers, streams its rows' Q tiles (and their
//   m, 1/l) through a three-stage cp.async ring, recomputes S^T = K Q^T on the
//   tensor cores, normalises, and sums per key weighted by validity / G
//   (cum) and by the last obs_len positions / G (obs, K4) or by each recent
//   window (K6). Partial sums go to a workspace [NA, n_seg, B, KVH, P]; a
//   small third launch (colsum_reduce) sums them over the segments in
//   segment order. No atomics: the result is deterministic. (The TPU kernel
//   accumulated across sequential grid steps, which Hopper's parallel blocks
//   cannot do.)
//
// A second entry point pair serves pallas_prefill.py::flash_profile (K6):
// the same pass 1, and pass 2 instantiated over the FastGen profile's
// accumulators: cum (every valid row) and, for up to four recent-window
// lengths w, the rows whose window holds the key (c <= pos <= c + w - 1).
//
// Bound on this card: operations. At P = 8192, head_dim 128 the causal
// products are ~0.55 TFLOP per layer (QK^T + PV), plus the pass-2
// recompute of QK^T; the inputs are ~100 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kBR = 64;           // pass 2: folded query rows per tile
constexpr int kBK = 64;           // pass 1: keys per tile
constexpr int kStride = kD + 8;   // shared-memory row stride in bf16
constexpr int kKeys2 = 128;       // pass 2: keys per work item (8 warps x 16)
constexpr int kThreads2 = 256;
constexpr int kStages2 = 3;       // pass 2: Q tiles in flight
constexpr int kBR1 = 128;         // pass 1: folded query rows per CTA (8 warps x 16)
constexpr int kThreads1 = 256;
constexpr int kStages1 = 3;       // pass 1: K/V tiles in flight
constexpr int kTile = kBK * kStride;  // bf16 elements of one tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// floor(x / G) for 0 <= x < 2^32 / G by one multiply-high with
// magic = ceil(2^32 / G) (exact: the error stays under 1 / G there).
__device__ __forceinline__ int div_g(int x, int G, uint32_t magic) {
  return G == 1 ? x : (int)__umulhi((uint32_t)x, magic);
}

// Element offset of folded row r of (b, kvh) in a [B, H, P, D] tensor.
__device__ __forceinline__ size_t qrow_offset(int b, int kvh, int r, int H, int G, int P) {
  return (((size_t)b * H + (size_t)kvh * G + (r % G)) * P + r / G) * kD;
}

// ROWS folded query rows from r0 into a padded tile; rows at or past
// `nrows` are left as they are (their results are not written).
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_q_tile(__nv_bfloat16* dst,
                                            const __nv_bfloat16* __restrict__ q, int b,
                                            int kvh, int r0, int H, int G, int P) {
  const int nrows = P * G;
  for (int idx = threadIdx.x; idx < ROWS * (kD / 8); idx += THREADS) {
    const int row = idx >> 4, ch = idx & 15;
    if (r0 + row < nrows)
      cp_async16(dst + row * kStride + ch * 8,
                 q + qrow_offset(b, kvh, r0 + row, H, G, P) + ch * 8);
  }
}

// ROWS contiguous rows of K or V into a padded tile, the first `valid` of
// them (the rest are left as they are).
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* __restrict__ src,
                                             int valid = ROWS) {
  for (int idx = threadIdx.x; idx < ROWS * (kD / 8); idx += THREADS) {
    const int row = idx >> 4, ch = idx & 15;
    if (row < valid) cp_async16(dst + row * kStride + ch * 8, src + (size_t)row * kD + ch * 8);
  }
}

// A fragments of 16 rows (row0 ..) of a padded tile, all 8 k-steps of
// D = 128: (rows 0-7 | 8-15) x (k lo | k hi) as ldmatrix's four matrices.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[8][4], const __nv_bfloat16* tile,
                                             int row0, int lane) {
  const __nv_bfloat16* p =
      tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) ldmatrix_x4(a[ks], p + ks * 16);
}

// s[nt] += A(16 rows) . B(64 rows of a padded tile, nt*8 ..)^T over D:
// ldmatrix gives the B fragments of two 8-row n-tiles per call.
__device__ __forceinline__ void scores_16x64(float (&s)[8][4], const uint32_t (&a)[8][4],
                                             const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
  const __nv_bfloat16* p =
      tile + ((lane & 7) + ((lane >> 4) & 1) * 8) * kStride + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, p + np * 16 * kStride + ks * 16);
      mma_bf16(s[2 * np], a[ks], bf[0], bf[1]);
      mma_bf16(s[2 * np + 1], a[ks], bf[2], bf[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads1, 1)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ y,
                 float* __restrict__ mbuf, float* __restrict__ ilbuf, int H, int KVH, int P,
                 float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBR1 * kStride;  // [kStages1][kTile]
  __nv_bfloat16* Vs = Ks + kStages1 * kTile;  // [kStages1][kTile]

  const int G = H / KVH;
  const int bh = blockIdx.x, b = bh / KVH, kvh = bh % KVH;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBR1;  // longest blocks first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nrows = P * G;

  const int rowA = r0 + warp * 16 + gid, rowB = rowA + 8;
  const int posA = rowA / G, posB = rowB / G;
  const int first_pos = r0 / G;
  const int n_kb = (min(r0 + kBR1, nrows) - 1) / G / kBK + 1;
  const __nv_bfloat16* Kb = k + (size_t)bh * P * kD;
  const __nv_bfloat16* Vb = v + (size_t)bh * P * kD;

  // Group t holds K/V tile t (group 0 also Q); one group per step, empty
  // past the last tile, so that waiting for all but the newest group at
  // step kb means tile kb has landed.
  load_q_tile<kBR1, kThreads1>(Qs, q, b, kvh, r0, H, G, P);
#pragma unroll
  for (int t = 0; t < kStages1 - 1; ++t) {
    if (t < n_kb) {
      load_kv_tile<kBK, kThreads1>(Ks + t * kTile, Kb + (size_t)t * kBK * kD);
      load_kv_tile<kBK, kThreads1>(Vs + t * kTile, Vb + (size_t)t * kBK * kD);
    }
    cp_async_commit();
  }

  uint32_t qa[8][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[16][4];
#pragma unroll
  for (int dt = 0; dt < 16; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[dt][j] = 0.f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb % kStages1;
    cp_async_wait<kStages1 - 2>();
    // Tile kb is in, and every warp is past tile kb - 1, whose stage the
    // next copy reuses: one barrier per tile.
    __syncthreads();
    {
      const int t = kb + kStages1 - 1;
      if (t < n_kb) {
        load_kv_tile<kBK, kThreads1>(Ks + (t % kStages1) * kTile, Kb + (size_t)t * kBK * kD);
        load_kv_tile<kBK, kThreads1>(Vs + (t % kStages1) * kTile, Vb + (size_t)t * kBK * kD);
      }
      cp_async_commit();
    }
    if (kb == 0) load_a_frags(qa, Qs, warp * 16, lane);

    float s[8][4];
    scores_16x64(s, qa, Ks + st * kTile, lane);
    // Keys past a row's position only in the tiles that reach the block's
    // first position. The maximum is taken over the unscaled scores (the
    // scale is positive) and the scale rides in the exponent's FMA.
    float mx0 = kNegInf, mx1 = kNegInf;
    if (kb * kBK + kBK - 1 > first_pos) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = kb * kBK + nt * 8 + tig * 2 + j;
          if (col > posA) s[nt][j] = kNegInf;
          if (col > posB) s[nt][2 + j] = kNegInf;
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m[0], mx0 * scale_log2), mn1 = fmaxf(m[1], mx1 * scale_log2);
    const float a0 = exp2f(m[0] - mn0), a1 = exp2f(m[1] - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = exp2f(fmaf(s[nt][j], scale_log2, -mn0));
        s[nt][2 + j] = exp2f(fmaf(s[nt][2 + j], scale_log2, -mn1));
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
    // O += bf16(e) . V: the score fragments of two n-tiles are the A
    // fragment of one 16-key step; V's B fragments come transposed.
    const __nv_bfloat16* vp = Vs + st * kTile +
                              ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dp = 0; dp < 8; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vp + kk * 16 * kStride + dp * 16);
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = hh == 0 ? rowA : rowB;
    if (r >= nrows) continue;
    __nv_bfloat16* yr = y + qrow_offset(b, kvh, r, H, G, P);
#pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      const float v0 = __fdiv_rn(o[dt][2 * hh], l[hh]);
      const float v1 = __fdiv_rn(o[dt][2 * hh + 1], l[hh]);
      *reinterpret_cast<uint32_t*>(yr + dt * 8 + tig * 2) = pack_bf16(v0, v1);
    }
    if (tig == 0) {
      mbuf[(size_t)bh * nrows + r] = m[hh];
      ilbuf[(size_t)bh * nrows + r] = __fdiv_rn(1.0f, l[hh]);
    }
  }
}

// Pass 2, one template over the accumulators: a = 0 is cum (every valid
// row, weight 1 / G); a = 1 .. NX are obs (OBS: the last obs_len valid
// positions) or the recent windows win[a - 1] (c <= pos <= c + w - 1).
template <bool OBS, int NX>
__global__ void __launch_bounds__(kThreads2, 2)
colsum_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const float* __restrict__ mbuf, const float* __restrict__ ilbuf,
              const int* __restrict__ plen_arr, float* __restrict__ ws, int H, int KVH,
              int P, float scale_log2, int seg_rows, int n_seg, int obs_len, int4 win) {
  constexpr int NA = 1 + NX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kKeys2][kStride]
  __nv_bfloat16* Qs = Ks + kKeys2 * kStride;                 // [kStages2][kTile]
  float* ml = reinterpret_cast<float*>(Qs + kStages2 * kTile);  // [kStages2][2][kBR]: m, 1/l

  const int G = H / KVH;
  const int bh = blockIdx.y, b = bh / KVH, kvh = bh % KVH;
  const int kb = blockIdx.x / n_seg, seg = blockIdx.x % n_seg;
  const int key0 = kb * kKeys2;
  const int plen = min(plen_arr[b], P);
  const int row_begin = max(seg * seg_rows, key0 * G);
  const int row_end = min((seg + 1) * seg_rows, plen * G);
  if (row_begin >= row_end) return;  // no valid row of this segment sees these keys
  const int n_tiles = (row_end - row_begin + kBR - 1) / kBR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nrows = P * G;
  const size_t bhP = (size_t)bh * P;

  auto load_rows = [&](int t, int st) {
    const int r0 = row_begin + t * kBR;
    load_q_tile<kBR, kThreads2>(Qs + st * kTile, q, b, kvh, r0, H, G, P);
    if (threadIdx.x < 2 * kBR / 4) {  // m and 1/l of the 64 rows, 16 bytes a thread
      const int which = threadIdx.x / (kBR / 4), ch = threadIdx.x % (kBR / 4);
      const float* src = (which ? ilbuf : mbuf) + (size_t)bh * nrows + r0 + ch * 4;
      cp_async16(ml + (st * 2 + which) * kBR + ch * 4, src);
    }
  };
  // The last block may reach past P (a multiple of 64 only): its second
  // half's warps hold no keys and write nothing.
  load_kv_tile<kKeys2, kThreads2>(Ks, k + (bhP + key0) * kD, P - key0);
  load_rows(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_rows(1, 1);
  cp_async_commit();

  const float wg = 1.0f / (float)G;
  const uint32_t gmagic = G == 1 ? 0u : 0xFFFFFFFFu / (uint32_t)G + 1u;
  const int wkey0 = key0 + warp * 16;  // this warp's 16 keys
  const bool has_keys = wkey0 < P;
  const int keyA = wkey0 + gid, keyB = keyA + 8;
  const int wl[4] = {win.x, win.y, win.z, win.w};
  uint32_t ka[8][4];
  float acc[NA][2];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a][0] = acc[a][1] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages2;
    cp_async_wait<kStages2 - 2>();
    // Tile t is in, and every warp is past tile t - 1, whose stage the next
    // copy reuses: one barrier per tile.
    __syncthreads();
    if (t + 2 < n_tiles) load_rows(t + 2, (t + 2) % kStages2);
    cp_async_commit();
    if (t == 0) load_a_frags(ka, Ks, warp * 16, lane);

    // s^T: 16 keys of this warp (rows gid, gid + 8) x 64 query rows.
    float s[8][4];
    scores_16x64(s, ka, Qs + st * kTile, lane);
    const int r0 = row_begin + t * kBR;
    const float* mt = ml + st * 2 * kBR;
    const float* ilt = mt + kBR;
    // Per tile, uniform across the warp: whether every row sees every key,
    // is valid, and falls wholly in or out of each extra accumulator; the
    // tiles inside the causal triangle then skip every per-element test.
    const int pos_lo = div_g(r0, G, gmagic), pos_hi = div_g(r0 + kBR - 1, G, gmagic);
    bool fast = pos_lo >= wkey0 + 15 && pos_hi < plen;
    bool all_in[NX > 0 ? NX : 1];
#pragma unroll
    for (int x = 0; x < NX; ++x) {
      bool none;
      if constexpr (OBS) {
        all_in[x] = pos_lo >= plen - obs_len;
        none = pos_hi < plen - obs_len;
      } else {
        all_in[x] = pos_hi - wkey0 < wl[x];
        none = pos_lo - (wkey0 + 15) >= wl[x];
      }
      fast = fast && (all_in[x] || none);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 mr = *reinterpret_cast<const float2*>(mt + nt * 8 + tig * 2);
      const float2 il = *reinterpret_cast<const float2*>(ilt + nt * 8 + tig * 2);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float m_r = j ? mr.y : mr.x, il_r = j ? il.y : il.x;
        float pA = exp2f(fmaf(s[nt][j], scale_log2, -m_r)) * il_r;
        float pB = exp2f(fmaf(s[nt][2 + j], scale_log2, -m_r)) * il_r;
        if (fast) {
          acc[0][0] += pA;
          acc[0][1] += pB;
#pragma unroll
          for (int x = 0; x < NX; ++x) {
            acc[1 + x][0] += all_in[x] ? pA : 0.f;
            acc[1 + x][1] += all_in[x] ? pB : 0.f;
          }
          continue;
        }
        const int pos = div_g(r0 + nt * 8 + tig * 2 + j, G, gmagic);
        if (keyA > pos || pos >= plen) pA = 0.f;
        if (keyB > pos || pos >= plen) pB = 0.f;
        acc[0][0] += pA;
        acc[0][1] += pB;
#pragma unroll
        for (int x = 0; x < NX; ++x) {
          if constexpr (OBS) {
            const bool in = pos >= plen - obs_len;
            acc[1 + x][0] += in ? pA : 0.f;
            acc[1 + x][1] += in ? pB : 0.f;
          } else {
            acc[1 + x][0] += pos - keyA < wl[x] ? pA : 0.f;
            acc[1 + x][1] += pos - keyB < wl[x] ? pB : 0.f;
          }
        }
      }
    }
  }

  // Sum each key's four lanes, then one lane writes the segment's partials.
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = acc[a][hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v *= wg;
      if (tig == 0 && has_keys) {
        const size_t bkp = (size_t)gridDim.y * P;  // one segment's [B, KVH, P]
        ws[((size_t)a * n_seg + seg) * bkp + bhP + (hh ? keyB : keyA)] = v;
      }
    }
  }
}

// out[a] [B, KVH, P] = the segments' partials of each key, summed in
// segment order over the segments that hold its valid rows (0 for keys no
// valid row sees).
__global__ void colsum_reduce(const float* __restrict__ ws, const int* __restrict__ plen_arr,
                              float* __restrict__ out, int KVH, int P, int G, int seg_rows,
                              int n_seg, int NA) {
  const int key = blockIdx.x * blockDim.x + threadIdx.x;
  if (key >= P) return;
  const int bh = blockIdx.y, b = bh / KVH;
  const size_t bkp = (size_t)gridDim.y * P;
  const int key0 = key / kKeys2 * kKeys2;
  const int plen = min(plen_arr[b], P);
  const int first = key0 * G / seg_rows;
  const int last = key0 < plen ? (plen * G - 1) / seg_rows : first - 1;
  for (int a = 0; a < NA; ++a) {
    float s = 0.f;
    for (int sg = first; sg <= last; ++sg) s += ws[((size_t)a * n_seg + sg) * bkp + (size_t)bh * P + key];
    out[(size_t)a * bkp + (size_t)bh * P + key] = s;
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool OBS, int NX>
cudaError_t launch_colsum(const void* q, const void* k, const void* mbuf, const void* ilbuf,
                          const void* plen, void* ws, void* out, int B, int H, int KVH, int P,
                          float scale_log2, int seg_rows, int n_seg, int obs_len, int4 win,
                          cudaStream_t stream) {
  const size_t smem = (size_t)(kKeys2 + kStages2 * kBR) * kStride * sizeof(__nv_bfloat16) +
                      kStages2 * 2 * kBR * sizeof(float);
  cudaError_t e = set_smem((const void*)colsum_kernel<OBS, NX>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((P + kKeys2 - 1) / kKeys2 * n_seg, B * KVH);
  colsum_kernel<OBS, NX><<<grid, kThreads2, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const float*)mbuf,
      (const float*)ilbuf, (const int*)plen, (float*)ws, H, KVH, P, scale_log2, seg_rows, n_seg,
      obs_len, win);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  colsum_reduce<<<dim3((P + 127) / 128, B * KVH), 128, 0, stream>>>(
      (const float*)ws, (const int*)plen, (float*)out, KVH, P, H / KVH, seg_rows, n_seg, 1 + NX);
  return cudaGetLastError();
}

}  // namespace

// Pass 1: y [B, H, P, D] bf16 and each folded row's m (base 2) and 1 / l,
// [B, KVH, P*G] f32. scale_log2 = log2(e) / sqrt(D).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* y, void* mbuf,
                         void* ilbuf, int B, int H, int KVH, int P, float scale_log2,
                         void* stream) {
  if (B < 1 || KVH < 1 || H % KVH || P < kBK || P % kBK) return (int)cudaErrorInvalidValue;
  const int G = H / KVH;
  const size_t smem = (size_t)(kBR1 + 2 * kStages1 * kBK) * kStride * sizeof(__nv_bfloat16);
  cudaError_t e = set_smem((const void*)flash_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * KVH, (P * G + kBR1 - 1) / kBR1);
  flash_fwd_kernel<<<grid, kThreads1, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)y, (float*)mbuf, (float*)ilbuf, H, KVH, P, scale_log2);
  return (int)cudaGetLastError();
}

// Pass 2 and the reduction over segments. mode 0 (K4): out [2, B, KVH, P] =
// cum, obs. mode 1 (K6): out [1 + n_windows, B, KVH, P] = cum, then one sum
// per window length w0..w3. ws: [1 + n_extra, n_seg, B, KVH, P] f32, with
// seg_rows a multiple of 64 and n_seg * seg_rows >= P * H / KVH.
extern "C" int flash_colsum(const void* q, const void* k, const void* mbuf, const void* ilbuf,
                            const void* plen, void* ws, void* out, int B, int H, int KVH, int P,
                            float scale_log2, int seg_rows, int n_seg, int mode, int obs_len,
                            int n_windows, int w0, int w1, int w2, int w3, void* stream) {
  if (B < 1 || KVH < 1 || H % KVH || P < kBK || P % kBK || seg_rows < kBR ||
      seg_rows % kBR || (size_t)n_seg * seg_rows < (size_t)P * (H / KVH))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int4 win = make_int4(w0, w1, w2, w3);
#define CCT_COLSUM(OBS_, NX_)                                                              \
  return (int)launch_colsum<OBS_, NX_>(q, k, mbuf, ilbuf, plen, ws, out, B, H, KVH, P,     \
                                       scale_log2, seg_rows, n_seg, obs_len, win, s)
  if (mode == 0) CCT_COLSUM(true, 1);
  switch (n_windows) {
    case 0: CCT_COLSUM(false, 0);
    case 1: CCT_COLSUM(false, 1);
    case 2: CCT_COLSUM(false, 2);
    case 3: CCT_COLSUM(false, 3);
    case 4: CCT_COLSUM(false, 4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CCT_COLSUM
}
