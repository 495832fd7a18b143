// Single-query GQA decode attention over a bf16 or affine-quantized KV cache,
// in one launch per call.
//
// Replaces the TPU kernels of cold_compress_tpu/ops/pallas_decode_attn.py::
// quantized_decode_attention, all of which compute one contract in either of
// two branches (`i8dot` off, or on for bits 8/4/2):
//   - the one-shot `_kernel` at bits 16/8/4/2, need_attn True or False;
//   - the chunked online-softmax kernels `_kernel_chunked(_ms)` and
//     `_chunk_step`, the manual double-buffered `_kernel_manual` and the slim
//     `_kernel_v2`, which serve caches above the one-shot VMEM budget.
// One kernel serves every cache length here, so it follows the one-shot
// numerics at every C. The dequantizing branch (I8 false):
//   k = bf16(u * s + z'), z' = z - 2^(BITS-1) * s   (BITS 8/4/2; no FMA)
//   k = the stored bf16 value                        (BITS 16)
//   scores = (q_bf16 . k) in f32 * 1/sqrt(D); masked slots -> -1e30
//   probs = softmax in f32 with the global (m, l) (in base 2: log2 e rides
//     in the scale, so exp becomes exp2; p = e * (1 / l));
//   pooled[c] = (sum_g probs[g][c]) * (1/G)
//   out = sum_c bf16(probs[g][c]) * v in f32, written in q's dtype
// The TPU's chunked kernel rounds the unnormalised e (not p) to bf16 before
// P.V; the difference is bounded in the tests.
//
// The i8dot branch (I8 true; `_i8_scores`, `_i8_pv`, pallas_decode_attn.py:
// 118-199) never dequantizes an element: u is the stored integer (kv8: the
// byte ^ 0x80 as int8, i.e. u - 128, with the raw zero z; kv4/kv2: the
// unsigned bit-range value, with the folded zero z'), and
//   qs = max(max_d |q|, 1e-8) * f32(1/127), qq = rint(q / qs) (int8),
//   scores = (f32(int32 qq . u) * qs * s + sum_d q * z) * 1/sqrt(D),
//   probs = softmax as above (f32; the pooled mean from these),
//   ps = max(max_c |p * s_v|, 1e-30) * f32(1/127), pq = rint(p * s_v / ps),
//   out = f32(int32 pq . u_v) * ps + sum_c p * z_v,
// each product an s8 x s8 -> s32 `mma.sync.m16n8k32` on the tensor cores.
// ps is a maximum over all C, but the cluster splits C: each CTA publishes,
// beside (m_s, l_s), the (score, |s_v|) of its slot with the largest
// exp(score - m_s) * |s_v|, and the fold recomputes that slot's |p * s_v|
// with the global (m, 1/l) exactly as the P.V loop forms it, so ps is the
// maximum of the very values the kernel quantizes, except where two slots of
// one CTA lie within an ulp or so of each other (then ps moves by about an
// ulp and only exact rounding ties of pq can move; tests bound the result).
// The int32 partials of P.V are summed exactly; the f32 sums of the zero
// term fold in CTA order like the rest. The TPU's chunked kernel quantizes
// each chunk's unnormalised e with its own scale (:274-296); this kernel
// follows the one-shot numerics at every C (the tests bound the gap). The
// int32 sums hold |pq . u_v| <= 127 * 128 * C, below 2^31 up to C = 131072.
//
// Storage: BITS 16 holds bf16 rows of D values. BITS 8 holds one byte per
// value. BITS 4/2 use the segment packing of caches/base.py::_pack_last:
// byte j, bit range s*BITS, holds column j + s*D/per (per = 8/BITS), as the
// TPU's `_dequant_segs` unpacks it.
//
// Bound on this card: bytes (K and V of every KV head, 2*C*D*BITS/8 bytes,
// plus the per-slot scale/zero/mask). At batch 1 there are only KVH heads,
// so each (batch, KV head) is one thread-block cluster of up to 16 CTAs
// that split C into contiguous ranges, and the cluster's CTAs meet through
// distributed shared memory instead of a second launch:
//   1. each CTA streams its K rows through a three-stage ring in shared
//      memory (cp.async by every thread, 32 KB of bf16 or kv8 rows a stage,
//      into rows padded so that the tensor-core fragment loads meet no bank
//      conflict; the per-slot scales and zeros ride beside them), computes
//      the G heads' scores on the tensor cores (q's fragments in registers,
//      K dequantized to bf16 straight into fragments) and keeps them in
//      shared memory (or, where they do not fit, in a global workspace),
//      then its local max m_s and sum l_s of exp(score - m_s); the first V
//      tiles are already loading;
//   2. cluster barrier; every CTA folds all the cluster's (m_s, l_s), read
//      from its peers' shared memory, in CTA order, so every CTA holds the
//      same global (m, l); it streams its V rows into a partial P.V, again
//      on the tensor cores, forming each p as it
//      goes: rounded to bf16 for the product (products of bf16 values are
//      exact; the f32 sums run in another order than the plain version's)
//      and summed over the heads for the pooled probabilities;
//   3. cluster barrier; CTA i sums column slice i of the output over the
//      cluster's partials in CTA order and writes it in q's dtype.
// Every sum has a fixed order (no atomics), so the result is deterministic.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 128;
constexpr int kMaxG = 8;
constexpr int kMaxCluster = 16;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kSmemScoreBytes = 64 * 1024;         // scores above this go to global
constexpr int kMaskPre = 8;                        // mask bytes a thread loads up front
constexpr float kNegInf = -1e30f;
constexpr float kInv127 = (float)(1.0 / 127.0);   // XLA's f32 constant for x / 127
constexpr int kStat = 4;                           // per head: m_s, l_s, candidate score, |s_v|

// Row layout of one cache format.
template <int BITS>
struct Fmt {
  static constexpr int kPer = BITS >= 8 ? 1 : 8 / BITS;  // values per byte
  static constexpr int kRowBytes = BITS == 16 ? kD * 2 : kD * BITS / 8;
  static constexpr int kSeg = kD / kPer;                // columns per bit range
  // Cache rows per ring stage (32 KB of bf16 or kv8 rows; a multiple of
  // 128 for the warps' row blocks).
  static constexpr int kTileRows = BITS == 16 ? 128 : BITS == 8 ? 256 : BITS == 4 ? 384 : 1024;
  // Row strides of a stage in shared memory, padded so that the lanes of
  // one shared-memory access hit distinct banks: K rows as the scores read
  // them, V rows as P.V reads them (see k_quarter and VLane).
  static constexpr int kKStride = BITS == 16 ? 320 : BITS == 8 ? 144 : kRowBytes;
  static constexpr int kVStride = BITS == 16 ? 288 : BITS == 8 ? 160 : BITS == 4 ? 96 : 32;
  static constexpr int kStageBytes =
      kTileRows * (kKStride > kVStride ? kKStride : kVStride);
  static constexpr int kSideFloats = BITS == 16 ? 0 : 2 * kTileRows;  // scales, zeros
};

// Byte offsets of one CTA's dynamic shared memory; qz, qst, redc and partz
// are the i8dot branch's only (empty otherwise).
struct Layout {
  size_t side, redm, redl, stats, fin, part, qz, qst, redc, partz, scores, total;
};

template <int BITS>
__host__ __device__ inline Layout layout(int MG, int G, int per, bool smem_scores, bool i8) {
  Layout L;
  L.side = (size_t)kStages * Fmt<BITS>::kStageBytes;
  L.redm = L.side + (size_t)kStages * Fmt<BITS>::kSideFloats * 4;
  L.redl = L.redm + kWarps * kMaxG * 4;
  L.stats = L.redl + kWarps * kMaxG * 4;
  L.fin = L.stats + kMaxG * kStat * 4;
  L.part = L.fin + 3 * kMaxG * 4;
  L.qz = L.part + (size_t)MG * kD * 4;
  L.qst = L.qz + (i8 ? kMaxG * kD : 0);
  L.redc = L.qst + (i8 ? 2 * kMaxG * 4 : 0);
  L.partz = L.redc + (i8 ? 3 * kWarps * kMaxG * 4 : 0);
  L.scores = L.partz + (i8 ? kMaxG * 4 : 0);
  L.total = L.scores + (smem_scores ? (size_t)G * per * 4 : 0);
  return L;
}

__host__ __device__ inline int cta_slots(int C, int nc) { return (C + nc - 1) / nc; }

__host__ __device__ inline bool scores_fit(int G, int per) {
  return (size_t)G * per * 4 <= (size_t)kSmemScoreBytes;
}

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

// ---- asynchronous copies ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// N 32-bit words of shared memory from a 4*N-byte aligned address.
template <int N>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t* w) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[k];
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// m16n8k16 bf16 product on the tensor cores, f32 accumulate; A's rows 8-15
// (a1, a3) are zero here: at most 8 query heads.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// m16n8k32 s8 x s8 product on the tensor cores, s32 accumulate. A's rows are
// (a0, a2) = row gid, (a1, a3) = row gid + 8, columns 4 tig + 0..3 and
// 16 + 4 tig + 0..3; B's (b0, b1) the same k for column gid.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// i8dot scores S^T = K qq^T as m16n8k32 products: M = 16 cache rows (K's
// bytes are A fragments as stored), N = 8 >= G query heads, K = 32 of the
// 128 columns per step, four steps. Lane (gid, tig) reads the same quarter
// of its rows as the bf16 path (kRowBytes / 4 bytes); step ks, half h (a0/b0
// or a2/b1) takes one word of it, four values of consecutive columns from
// i8_kcol(tig, ks, h) on (kv4/kv2: one bit range of the word), and q's B
// fragment takes the same columns.
template <int BITS>
__device__ __forceinline__ int i8_kcol(int tig, int ks, int h) {
  if constexpr (BITS == 8) return tig * 32 + ks * 8 + h * 4;
  if constexpr (BITS == 4) return (ks >> 1) * 64 + tig * 16 + ((ks & 1) * 2 + h) * 4;
  return ks * 32 + tig * 8 + h * 4;  // BITS 2
}

// The signed A fragment of step ks, half h from the lane's quarter row `w`.
template <int BITS>
__device__ __forceinline__ uint32_t i8_kfrag(const uint32_t* w, int ks, int h) {
  if constexpr (BITS == 8) return w[2 * ks + h] ^ 0x80808080u;
  if constexpr (BITS == 4) return (w[(ks & 1) * 2 + h] >> ((ks >> 1) * 4)) & 0x0F0F0F0Fu;
  return (w[h] >> (ks * 2)) & 0x03030303u;  // BITS 2
}

// Four values of one V word as signed bytes (kv8: u ^ 0x80; kv4/kv2: the bit
// range at `shift` of each byte).
template <int BITS>
__device__ __forceinline__ uint32_t i8_vword(uint32_t w, int shift) {
  if constexpr (BITS == 8) return w ^ 0x80808080u;
  return (w >> shift) & (BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u);
}

// 4 x 4 byte transpose: w[j] holds row j's bytes of columns 0..3; t[c]
// becomes column c's bytes of rows 0..3 (a B fragment: four consecutive k).
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&t)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362), hi23 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xFF) | ((uint32_t)(b & 0xFF) << 8) | ((uint32_t)(c & 0xFF) << 16) |
         ((uint32_t)(d & 0xFF) << 24);
}

// Scores S = q K^T as m16n8k16 products: M = the G query heads, N = 8 cache
// rows, K = 16 of the 128 columns per step. The order of the columns in the
// dot product is free, so lane (gid, tig) takes a quarter of row gid's
// bytes (kRowBytes / 4 of them, 32 values: contiguous, or for bf16 four
// interleaved chunks) and step ks, value j (j = 0, 1: B's k = 2 tig + j;
// j = 2, 3: k = 8 + 2 tig + j - 2) is column kcol(tig, ks, j); q's A
// fragment takes the same columns.
template <int BITS>
__device__ __forceinline__ int kcol(int tig, int ks, int j) {
  // bf16: the lane's 16-byte chunks tig, tig + 4, tig + 8, tig + 12 (two
  // steps each), so that the four tig lanes of an access meet distinct banks.
  if constexpr (BITS == 16) return (tig + 4 * (ks >> 1)) * 8 + (ks & 1) * 4 + j;
  if constexpr (BITS == 8) return tig * 32 + ks * 4 + j;
  if constexpr (BITS == 4) return (ks >> 2) * 64 + tig * 16 + (ks & 3) * 4 + j;
  return (ks >> 1) * 32 + tig * 8 + (ks & 1) * 4 + j;  // BITS 2
}

// B fragment (b0: j = 0, 1; b1: j = 2, 3) of step ks from the lane's
// quarter row `w`, dequantized and rounded to bf16.
template <int BITS>
__device__ __forceinline__ void k_frag(const uint32_t* w, int ks, float s, float zp,
                                       uint32_t& b0, uint32_t& b1) {
  if constexpr (BITS == 16) {
    b0 = w[2 * ks];
    b1 = w[2 * ks + 1];
  } else {
    // The four values sit in one word: bytes 0-3, at bit offset `shift`
    // within each byte for the packed formats.
    const uint32_t word = BITS == 8 ? w[ks] : BITS == 4 ? w[ks & 3] : w[ks & 1];
    const int shift = BITS == 8 ? 0 : BITS == 4 ? (ks >> 2) * 4 : (ks >> 1) * 2;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = deq_bf16((word >> (8 * j + shift)) & ((1u << (BITS == 8 ? 8 : BITS)) - 1u), s, zp);
    b0 = pack_bf16(v[0], v[1]);
    b1 = pack_bf16(v[2], v[3]);
  }
}

// P.V as m16n8k16 products: M = the G query heads, K = 16 cache rows of a
// step, N = 8 columns per product. Lane (gid, tig) holds the rows tig,
// tig + 4, tig + 8, tig + 12 of the step (B's k = 2 tig + 0, 1 and
// 8 + 2 tig + 0, 1) and 8 columns of each, half * 64 + gid * 8 + n for the
// products n = 0..7, so that it reads 8 contiguous values of a row; the
// product's C column c (= 2 tig + j) is then output column half * 64 +
// c * 8 + n.
template <int BITS>
struct VLane {
  static constexpr int kWords = BITS == 16 ? 4 : 2;  // the 8 values' bytes
  __device__ static int byte0(int gid, int half) {
    if constexpr (BITS == 16) return half * 128 + gid * 16;
    if constexpr (BITS == 8) return half * 64 + gid * 8;
    if constexpr (BITS == 4) return gid * 8;
    return (gid & 3) * 8;  // BITS 2
  }
  __device__ static int shift(int gid, int half) {
    if constexpr (BITS == 4) return half * 4;
    if constexpr (BITS == 2) return (half * 2 + (gid >> 2)) * 2;
    return 0;
  }
};

// bf16 value n (0..7) of two rows' words, packed (row a low, row b high).
template <int BITS>
__device__ __forceinline__ uint32_t v_pair(const uint32_t* wa, const uint32_t* wb, int n,
                                           int shift, float sa, float za, float sb, float zb) {
  if constexpr (BITS == 16) {
    return __byte_perm(wa[n >> 1], wb[n >> 1], (n & 1) ? 0x7632 : 0x5410);
  } else {
    constexpr uint32_t mask = (1u << (BITS == 8 ? 8 : BITS)) - 1u;
    const int bit = 8 * (n & 3) + shift;
    return pack_bf16(deq_bf16((wa[n >> 2] >> bit) & mask, sa, za),
                     deq_bf16((wb[n >> 2] >> bit) & mask, sb, zb));
  }
}

// The CTA's ring: item i < nt is K tile i, item nt + i is V tile i, each
// kTileRows cache rows (the last one ragged) of this CTA's slot range,
// copied by every thread with cp.async into padded rows.
template <int BITS>
struct Ring {
  using F = Fmt<BITS>;
  uint8_t* rows;    // [kStages][kStageBytes]
  float* side;      // [kStages][2][kTileRows]: scales, then zeros
  const uint8_t* kc;
  const uint8_t* vc;
  const float *ks, *kz, *vs, *vz;
  size_t slot0;     // bh * C + c_begin
  int n, nt;

  __device__ int tile_rows(int i) const {
    const int t = i < nt ? i : i - nt;
    return min(F::kTileRows, n - t * F::kTileRows);
  }

  // Issue item i into its stage (nothing if it does not exist); always
  // commits one cp.async group, so that group i is item i.
  __device__ void issue(int i) {
    if (i < 2 * nt) {
      const int st = i % kStages;
      const bool is_k = i < nt;
      const int r0 = (is_k ? i : i - nt) * F::kTileRows;
      const int rows_i = tile_rows(i);
      constexpr int kChunks = F::kRowBytes / 16;  // per row
      const int stride = is_k ? F::kKStride : F::kVStride;
      uint8_t* dst = rows + (size_t)st * F::kStageBytes;
      const uint8_t* src = (is_k ? kc : vc) + (slot0 + r0) * F::kRowBytes;
      for (int c = threadIdx.x; c < rows_i * kChunks; c += kThreads) {
        const int r = c / kChunks, ch = c % kChunks;
        cp_async16(dst + r * stride + ch * 16, src + (size_t)c * 16);
      }
      if constexpr (BITS != 16) {
        const float* s = is_k ? ks : vs;
        const float* z = is_k ? kz : vz;
        float* sd = side + (size_t)st * F::kSideFloats;
        for (int t = threadIdx.x; t < 2 * rows_i; t += kThreads) {
          const int r = t < rows_i ? t : t - rows_i;
          cp_async4(sd + (t < rows_i ? r : F::kTileRows + r), (t < rows_i ? s : z) + slot0 + r0 + r);
        }
      }
    }
    cp_async_commit();
  }

  // Wait for item i, visible to the whole CTA.
  __device__ void wait(int i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
  }
};

// ---- the i8dot branch's P.V, its sums and the output (after the fold) ----
// P.V as m16n8k32 s8 products: M = the G query heads (rows 8-15 zero), K = 32
// cache rows of a step, N = 8 columns per product. Lane (gid, tig) holds, of
// each 16-row half hb of the step, the rows r32 + 16 hb + tig + 4 j (j = 0..3,
// A's and B's k = 4 tig + j; rows 4 apart so that the four tig lanes of an
// access meet distinct banks), and 8 values of each row as VLane reads them
// for the bf16 path; a 4 x 4 byte transpose turns four rows' words into B
// fragments of four columns. The product's C column c (= 2 tig + j) is then
// output column half * 64 + c * 8 + nn, as in the bf16 path.
template <int BITS, bool NEED_ATTN, int MG>
__device__ __forceinline__ void i8_pv(Ring<BITS>& ring, const float* sc, size_t ss,
                                      const float* fin, float* pooled, float* part,
                                      float* partz, float* redz, size_t bh, int C, int c_begin,
                                      int G, int nc, int rank, void* out, int out_bf16,
                                      cg::cluster_group& cluster) {
  using F = Fmt<BITS>;
  using VL = VLane<BITS>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nt = ring.nt;
  // Warp w takes column half w & 1 of the 32-row steps w >> 1, w >> 1 + kWarps / 2, ...
  constexpr int kSteps = (F::kTileRows / 32 * 2 + kWarps - 1) / kWarps;
  const int half = warp & 1;
  const int vbyte = VL::byte0(gid, half), vshift = VL::shift(gid, half);
  const bool head = gid < G;
  const float m = head ? fin[gid] : 0.f, il = head ? fin[kMaxG + gid] : 0.f;
  const float ps = head ? fin[2 * kMaxG + gid] : 1.f;
  int o[8][4] = {};
  float zt = 0.f;  // this lane's share of sum_c p * z_v for head gid
  for (int i = nt; i < 2 * nt; ++i) {
    ring.wait(i);
    const int st = i % kStages;
    const int rows_i = ring.tile_rows(i);
    const int t0 = (i - nt) * F::kTileRows;
    const uint8_t* tile = ring.rows + (size_t)st * F::kStageBytes;
    const float* side = ring.side + (size_t)st * F::kSideFloats;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int r32 = ((warp >> 1) + u * (kWarps / 2)) * 32;
      if (r32 >= rows_i) break;  // uniform across the warp
      float p[8];
      int pq[8];
      uint32_t vw[8][2];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int key = r32 + (rr >> 2) * 16 + tig + 4 * (rr & 3);
        p[rr] = 0.f;
        pq[rr] = 0;
        if (head && key < rows_i) {
          // p with the global (m, 1 / l), as the fold formed ps's candidates.
          p[rr] = __fmul_rn(exp2f(sc[gid * ss + t0 + key] - m), il);
          const float sv = side[key];
          const float zv = BITS == 8 ? side[F::kTileRows + key]
                                     : folded_zero<BITS>(side[F::kTileRows + key], sv);
          pq[rr] = __float2int_rn(__fdiv_rn(__fmul_rn(p[rr], sv), ps));
          zt = __fadd_rn(zt, __fmul_rn(p[rr], zv));
        }
        // Rows past the ragged end hold stale bytes; they meet pq = 0.
        load_words<2>(tile + (size_t)key * F::kVStride + vbyte, vw[rr]);
      }
      if constexpr (NEED_ATTN) {
        // Sum over the heads (the lanes of one tig); half 0 writes it.
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          float v = p[rr];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          const int key = r32 + (rr >> 2) * 16 + tig + 4 * (rr & 3);
          if (half == 0 && gid == 0 && key < rows_i)
            pooled[bh * C + c_begin + t0 + key] = v * (1.0f / (float)G);
        }
      }
      const uint32_t a0 = pack_s8(pq[0], pq[1], pq[2], pq[3]);
      const uint32_t a2 = pack_s8(pq[4], pq[5], pq[6], pq[7]);
#pragma unroll
      for (int wd = 0; wd < 2; ++wd) {
        uint32_t w0[4], w1[4], b0[4], b1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w0[j] = i8_vword<BITS>(vw[j][wd], vshift);
          w1[j] = i8_vword<BITS>(vw[4 + j][wd], vshift);
        }
        transpose4(w0, b0);
        transpose4(w1, b1);
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_s8(o[wd * 4 + c], a0, 0u, a2, 0u, b0[c], b1[c]);
      }
    }
    __syncthreads();
    ring.issue(i + kStages);
  }

  // Sum the warps of each column half in order, in s32 (exact; the ring is
  // free now), and the zero term's shares (lanes of a head, then the half-0
  // warps in order). o[nn][j]: head gid, column half * 64 + (2 tig + j) * 8 + nn.
  int* red = reinterpret_cast<int*>(ring.rows);  // [kWarps][MG][kD]
  if (head) {
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        red[(warp * MG + gid) * kD + half * 64 + (tig * 2 + j) * 8 + nn] = o[nn][j];
  }
  zt += __shfl_xor_sync(0xffffffffu, zt, 1);
  zt += __shfl_xor_sync(0xffffffffu, zt, 2);
  if (half == 0 && tig == 0 && head) redz[warp * kMaxG + gid] = zt;
  __syncthreads();
  int* ipart = reinterpret_cast<int*>(part);
  for (int e = tid; e < G * kD; e += kThreads) {
    const int dh = (e >> 6) & 1;  // the column's half
    int sum = 0;
    for (int w = dh; w < kWarps; w += 2) sum += red[w * MG * kD + e];
    ipart[e] = sum;
  }
  if (tid < G) {
    float z = 0.f;
    for (int w = 0; w < kWarps; w += 2) z += redz[w * kMaxG + tid];
    partz[tid] = z;
  }

  // Column slice `rank` of the output: the cluster's s32 partials summed,
  // then f32(sum) * ps + (zero term summed in CTA order).
  cluster.sync();
  const int E = G * kD;
  const int chunk = (E + nc - 1) / nc;
  const int e1 = min(E, (rank + 1) * chunk);
  for (int e = rank * chunk + tid; e < e1; e += kThreads) {
    const int g = e / kD;
    int s = 0;
    float z = 0.f;
    for (int r = 0; r < nc; ++r) {
      s += cluster.map_shared_rank(ipart, r)[e];
      z += cluster.map_shared_rank(partz, r)[g];
    }
    const float y = __fadd_rn(__fmul_rn((float)s, fin[2 * kMaxG + g]), z);
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[bh * E + e] = __float2bfloat16(y);
    else
      reinterpret_cast<float*>(out)[bh * E + e] = y;
  }
  // Peers may still read this CTA's partials.
  cluster.sync();
}

template <int BITS, bool NEED_ATTN, int MG, bool I8>
__global__ void __launch_bounds__(kThreads, 1)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,  // [B, H, D]
                   const uint8_t* __restrict__ kc,       // [B, KVH, C, row bytes]
                   const uint8_t* __restrict__ vc,
                   const float* __restrict__ ks, const float* __restrict__ kz,
                   const float* __restrict__ vs, const float* __restrict__ vz,
                   const uint8_t* __restrict__ mask,     // [B, KVH, C]
                   void* __restrict__ out,               // [B, H, D], bf16 or f32
                   float* __restrict__ pooled,           // [B, KVH, C]
                   float* __restrict__ ws_scores,        // [B, KVH, G, C] or unused
                   int KVH, int C, int G, int per, int smem_scores, int out_bf16,
                   float scale) {
  using F = Fmt<BITS>;
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = (size_t)b * KVH + h;
  const int c_begin = min(C, rank * per);
  const int n = min(C, c_begin + per) - c_begin;

  const Layout L = layout<BITS>(MG, G, per, smem_scores, I8);
  float* redm = reinterpret_cast<float*>(smem + L.redm);   // [kWarps][kMaxG]
  float* redl = reinterpret_cast<float*>(smem + L.redl);   // [kWarps][kMaxG]
  float* stats = reinterpret_cast<float*>(smem + L.stats); // [kMaxG][kStat]
  float* fin = reinterpret_cast<float*>(smem + L.fin);     // [3][kMaxG]: m, 1 / l, ps
  float* part = reinterpret_cast<float*>(smem + L.part);   // [G][kD], s32 for I8
  uint8_t* qz = smem + L.qz;                               // [kMaxG][kD] int8 q (I8)
  float* qst = reinterpret_cast<float*>(smem + L.qst);     // [2][kMaxG]: qs, sum q (I8)
  float* redc = reinterpret_cast<float*>(smem + L.redc);   // [kWarps][kMaxG][3] (I8)
  float* partz = reinterpret_cast<float*>(smem + L.partz); // [kMaxG]: sum p z_v (I8)
  // Scores of head g at local slot c: sc[g * ss + c].
  float* sc = smem_scores ? reinterpret_cast<float*>(smem + L.scores)
                          : ws_scores + bh * G * C + c_begin;
  const size_t ss = smem_scores ? (size_t)per : (size_t)C;

  Ring<BITS> ring;
  ring.rows = smem;
  ring.side = reinterpret_cast<float*>(smem + L.side);
  ring.kc = kc;
  ring.vc = vc;
  ring.ks = ks;
  ring.kz = kz;
  ring.vs = vs;
  ring.vz = vz;
  ring.slot0 = bh * C + c_begin;
  ring.n = n;
  ring.nt = (n + F::kTileRows - 1) / F::kTileRows;
  const int nt = ring.nt;

  // Before the ring's copies queue up: q's A fragments (head gid, the
  // columns kcol gives this lane), and the first mask bytes (I8: and V
  // scales) of the slots this thread owns in the softmax below.
  const int gid = lane >> 2, tig = lane & 3;
  uint32_t qa[8][2];
  if constexpr (!I8) {
    const unsigned short* qh = reinterpret_cast<const unsigned short*>(q) + (bh * G + gid) * kD;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        qa[kk][h2] = gid < G ? (uint32_t)qh[kcol<BITS>(tig, kk, 2 * h2)] |
                                   ((uint32_t)qh[kcol<BITS>(tig, kk, 2 * h2 + 1)] << 16)
                             : 0u;
  }
  bool okpre[kMaskPre];
  float svpre[kMaskPre];
#pragma unroll
  for (int u = 0; u < kMaskPre; ++u) {
    const int c = u * kThreads + tid;
    okpre[u] = c < n && mask[bh * C + c_begin + c];
    if constexpr (I8) svpre[u] = c < n ? fabsf(vs[bh * C + c_begin + c]) : 0.f;
  }

#pragma unroll
  for (int i = 0; i < kStages; ++i) ring.issue(i);

  // i8dot: warp g quantizes head g's q (lane: columns 4 lane + 0..3) while
  // the first tiles load; then every lane takes its B fragments (head gid,
  // the columns i8_kcol gives) and the scales and sums of heads 2 tig, 2 tig + 1.
  uint32_t qb[4][2];
  float qs2[2], qsum2[2];
  if constexpr (I8) {
    if (warp < G) {
      const uint2 raw = *reinterpret_cast<const uint2*>(q + (bh * G + warp) * kD + lane * 4);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      const float qf[4] = {__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi)};
      float amax = fmaxf(fmaxf(fabsf(qf[0]), fabsf(qf[1])), fmaxf(fabsf(qf[2]), fabsf(qf[3])));
      float sum = (qf[0] + qf[1]) + (qf[2] + qf[3]);
      for (int off = 16; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      const float qs = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
      int qi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) qi[j] = __float2int_rn(__fdiv_rn(qf[j], qs));
      reinterpret_cast<uint32_t*>(qz + warp * kD)[lane] = pack_s8(qi[0], qi[1], qi[2], qi[3]);
      if (lane == 0) {
        qst[warp] = qs;
        qst[kMaxG + warp] = sum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        qb[ks][h2] = gid < G ? *reinterpret_cast<const uint32_t*>(
                                   qz + gid * kD + i8_kcol<BITS>(tig, ks, h2))
                             : 0u;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = 2 * tig + j < G;
      qs2[j] = ok ? qst[2 * tig + j] : 0.f;
      qsum2[j] = ok ? qst[kMaxG + 2 * tig + j] : 0.f;
    }
  }

  // ---- 1. scores on the tensor cores: 8 (I8: 16) cache rows per product ----
  constexpr int kRowTiles = F::kTileRows / 8 / kWarps;  // products per warp per tile
  constexpr int kRowBlocks = (F::kTileRows / 16 + kWarps - 1) / kWarps;  // I8: 16-row blocks
  constexpr int kQuarter = F::kRowBytes / 4;             // a lane's bytes of a row
  for (int i = 0; i < nt; ++i) {
    ring.wait(i);
    const int st = i % kStages;
    const int rows_i = ring.tile_rows(i);
    const uint8_t* tile = ring.rows + (size_t)st * F::kStageBytes;
    const float* side = ring.side + (size_t)st * F::kSideFloats;
    // Rows past the ragged end compute on stale bytes and are not written.
    if constexpr (I8) {
#pragma unroll
      for (int u = 0; u < kRowBlocks; ++u) {
        const int r16 = (warp + u * kWarps) * 16;
        if (r16 >= rows_i) break;  // uniform across the warp
        uint32_t wa[kQuarter / 4], wb[kQuarter / 4];
        load_words<kQuarter / 4>(tile + (size_t)(r16 + gid) * F::kKStride + tig * kQuarter, wa);
        load_words<kQuarter / 4>(tile + (size_t)(r16 + gid + 8) * F::kKStride + tig * kQuarter, wb);
        int c4[4] = {0, 0, 0, 0};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          mma_s8(c4, i8_kfrag<BITS>(wa, ks, 0), i8_kfrag<BITS>(wb, ks, 0),
                 i8_kfrag<BITS>(wa, ks, 1), i8_kfrag<BITS>(wb, ks, 1), qb[ks][0], qb[ks][1]);
        // c4[2 rr + j]: row r16 + gid + 8 rr, head 2 tig + j.
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int key = r16 + gid + 8 * rr;
          if (key >= rows_i) continue;
          const float sk = side[key];
          const float zk = BITS == 8 ? side[F::kTileRows + key]
                                     : folded_zero<BITS>(side[F::kTileRows + key], sk);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int g = 2 * tig + j;
            if (g < G)
              sc[g * ss + i * F::kTileRows + key] = __fmul_rn(
                  __fadd_rn(__fmul_rn(__fmul_rn((float)c4[2 * rr + j], qs2[j]), sk),
                            __fmul_rn(qsum2[j], zk)),
                  scale);
          }
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRowTiles; ++u) {
        const int r8 = (warp + u * kWarps) * 8;
        if (r8 >= rows_i) break;  // uniform across the warp
        const int r = r8 + gid;
        uint32_t w[kQuarter / 4];
        const uint8_t* row = tile + (size_t)r * F::kKStride;
        if constexpr (BITS == 16) {
#pragma unroll
          for (int c = 0; c < 4; ++c) load_words<4>(row + (tig + 4 * c) * 16, w + 4 * c);
        } else {
          load_words<kQuarter / 4>(row + tig * kQuarter, w);
        }
        float s = 0.f, zp = 0.f;
        if constexpr (BITS != 16) {
          s = side[r];
          zp = folded_zero<BITS>(side[F::kTileRows + r], s);
        }
        // Two accumulators (even and odd steps) halve the chain of
        // dependent products.
        float c4[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          uint32_t b0, b1;
          k_frag<BITS>(w, kk, s, zp, b0, b1);
          mma_bf16(c4[kk & 1], qa[kk][0], qa[kk][1], b0, b1);
        }
        // c4[.][j]: head gid, row r8 + 2 tig + j.
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = r8 + tig * 2 + j;
          if (gid < G && key < rows_i)
            sc[gid * ss + i * F::kTileRows + key] = (c4[0][j] + c4[1][j]) * scale;
        }
      }
    }
    __syncthreads();
    ring.issue(i + kStages);
  }

  // ---- local softmax statistics over this CTA's slots, masked ----
  float mx[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g) mx[g] = kNegInf;
  for (int c0 = 0; c0 < n; c0 += kMaskPre * kThreads) {
    bool ok[kMaskPre];
#pragma unroll
    for (int u = 0; u < kMaskPre; ++u) {
      const int c = c0 + u * kThreads + tid;
      ok[u] = c0 == 0 ? okpre[u] : (c < n && mask[bh * C + c_begin + c]);
    }
#pragma unroll
    for (int u = 0; u < kMaskPre; ++u) {
      const int c = c0 + u * kThreads + tid;
      if (c >= n) break;
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g >= G) break;
        float v = sc[g * ss + c];
        if (!ok[u]) {
          v = kNegInf;
          sc[g * ss + c] = v;
        }
        mx[g] = fmaxf(mx[g], v);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    float v = mx[g];
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) redm[warp * kMaxG + g] = v;
  }
  __syncthreads();
  float ms[MG], ls[MG];
  // I8: per head, the slot with the largest exp(score - m_s) * |s_v| (its
  // value, score and |s_v|), for the cluster-wide ps.
  float bv[MG], bs[MG], bsv[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    ms[g] = redm[g];
    for (int w = 1; w < kWarps; ++w) ms[g] = fmaxf(ms[g], redm[w * kMaxG + g]);
    ls[g] = 0.f;
    bv[g] = -1.f;
    bs[g] = kNegInf;
    bsv[g] = 0.f;
  }
  for (int c0 = 0; c0 < n; c0 += kMaskPre * kThreads) {
#pragma unroll
    for (int u = 0; u < kMaskPre; ++u) {
      const int c = c0 + u * kThreads + tid;
      if (c >= n) break;
      float sv = 0.f;
      if constexpr (I8) sv = c0 == 0 ? svpre[u] : fabsf(vs[bh * C + c_begin + c]);
#pragma unroll
      for (int g = 0; g < MG; ++g)
        if (g < G) {
          const float s = sc[g * ss + c];
          const float e = exp2f(s - ms[g]);
          ls[g] += e;
          if constexpr (I8) {
            const float v = e * sv;
            if (v > bv[g]) {
              bv[g] = v;
              bs[g] = s;
              bsv[g] = sv;
            }
          }
        }
    }
  }
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    float v = ls[g];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) redl[warp * kMaxG + g] = v;
    if constexpr (I8) {
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv[g], off);
        const float os = __shfl_xor_sync(0xffffffffu, bs[g], off);
        const float osv = __shfl_xor_sync(0xffffffffu, bsv[g], off);
        if (ov > bv[g]) {
          bv[g] = ov;
          bs[g] = os;
          bsv[g] = osv;
        }
      }
      if (lane == 0) {
        float* r = redc + (warp * kMaxG + g) * 3;
        r[0] = bv[g];
        r[1] = bs[g];
        r[2] = bsv[g];
      }
    }
  }
  __syncthreads();
  if (tid < G) {
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += redl[w * kMaxG + tid];
    stats[tid * kStat] = ms[tid];
    stats[tid * kStat + 1] = l;
    if constexpr (I8) {
      const float* best = redc + tid * 3;
      for (int w = 1; w < kWarps; ++w) {
        const float* r = redc + (w * kMaxG + tid) * 3;
        if (r[0] > best[0]) best = r;
      }
      stats[tid * kStat + 2] = best[1];
      stats[tid * kStat + 3] = best[2];
    }
  }

  // ---- 2. global (m, l) from every CTA of the cluster, in CTA order ----
  cluster.sync();
  if (tid < G) {
    float m = kNegInf;
    for (int r = 0; r < nc; ++r) m = fmaxf(m, cluster.map_shared_rank(stats, r)[tid * kStat]);
    float l = 0.f;
    for (int r = 0; r < nc; ++r) {
      const float* st = cluster.map_shared_rank(stats, r);
      l += st[tid * kStat + 1] * exp2f(st[tid * kStat] - m);
    }
    const float il = __fdiv_rn(1.0f, l);
    fin[tid] = m;
    fin[kMaxG + tid] = il;
    if constexpr (I8) {
      // Each CTA's candidate |p * s_v|, formed as the P.V loop forms it.
      float amax = 0.f;
      for (int r = 0; r < nc; ++r) {
        const float* st = cluster.map_shared_rank(stats, r);
        amax = fmaxf(amax, fabsf(__fmul_rn(__fmul_rn(exp2f(st[tid * kStat + 2] - m), il),
                                           st[tid * kStat + 3])));
      }
      fin[2 * kMaxG + tid] = __fmul_rn(fmaxf(amax, 1e-30f), kInv127);
    }
  }
  __syncthreads();

  if constexpr (I8) {
    i8_pv<BITS, NEED_ATTN, MG>(ring, sc, ss, fin, pooled, part, partz, redc, bh, C, c_begin,
                                G, nc, rank, out, out_bf16, cluster);
    return;
  }

  // ---- partial P.V on the tensor cores: 16 cache rows per step ----
  // Warp w takes column half w & 1 of steps w >> 1, w >> 1 + kWarps / 2, ...
  using VL = VLane<BITS>;
  constexpr int kSteps = F::kTileRows / 16 * 2 / kWarps;  // (step, half) units per warp
  const int half = warp & 1;
  const int vbyte = VL::byte0(gid, half), vshift = VL::shift(gid, half);
  float o[8][4];
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nn][j] = 0.f;
  for (int i = nt; i < 2 * nt; ++i) {
    ring.wait(i);
    const int st = i % kStages;
    const int rows_i = ring.tile_rows(i);
    const int t0 = (i - nt) * F::kTileRows;
    const uint8_t* tile = ring.rows + (size_t)st * F::kStageBytes;
    const float* side = ring.side + (size_t)st * F::kSideFloats;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int r16 = ((warp >> 1) + u * (kWarps / 2)) * 16;
      if (r16 >= rows_i) break;  // uniform across the warp
      // This lane's 4 rows r16 + tig + 4 rr: probabilities of head gid (0
      // past the end), and 8 values of each row (0 past the end: stale
      // bytes may not be finite).
      float p[4], sv[4], zv[4];
      uint32_t vw[4][VL::kWords];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int key = r16 + tig + 4 * rr;
        const bool ok = key < rows_i;
        // p of head gid with the global (m, 1 / l); its bf16 rounding
        // enters P.V, the f32 value the pooled mean.
        p[rr] = gid < G && ok ? exp2f(sc[gid * ss + t0 + key] - fin[gid]) * fin[kMaxG + gid] : 0.f;
        load_words<VL::kWords>(tile + (size_t)key * F::kVStride + vbyte, vw[rr]);
        sv[rr] = zv[rr] = 0.f;
        if constexpr (BITS == 16) {
          if (!ok)
#pragma unroll
            for (int k = 0; k < VL::kWords; ++k) vw[rr][k] = 0u;
        } else {
          if (ok) {
            sv[rr] = side[key];
            zv[rr] = folded_zero<BITS>(side[F::kTileRows + key], sv[rr]);
          }
        }
      }
      if constexpr (NEED_ATTN) {
        // Sum over the heads (the lanes of one tig); half 0 writes it.
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          float v = p[rr];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          const int key = r16 + tig + 4 * rr;
          if (half == 0 && gid == 0 && key < rows_i)
            pooled[bh * C + c_begin + t0 + key] = v * (1.0f / (float)G);
        }
      }
      const uint32_t a0 = pack_bf16(p[0], p[1]), a2 = pack_bf16(p[2], p[3]);
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        const uint32_t b0 = v_pair<BITS>(vw[0], vw[1], nn, vshift, sv[0], zv[0], sv[1], zv[1]);
        const uint32_t b1 = v_pair<BITS>(vw[2], vw[3], nn, vshift, sv[2], zv[2], sv[3], zv[3]);
        mma_bf16(o[nn], a0, a2, b0, b1);
      }
    }
    __syncthreads();
    ring.issue(i + kStages);
  }

  // Sum the warps of each column half in order (the ring is free now),
  // then the CTA's partial. o[nn][j]: head gid, column half * 64 +
  // (2 tig + j) * 8 + nn.
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][MG][kD]
  if (gid < G) {
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        red[(warp * MG + gid) * kD + half * 64 + (tig * 2 + j) * 8 + nn] = o[nn][j];
  }
  __syncthreads();
  for (int e = tid; e < G * kD; e += kThreads) {
    const int dh = (e >> 6) & 1;  // the column's half
    float sum = 0.f;
    for (int w = dh; w < kWarps; w += 2) sum += red[w * MG * kD + e];
    part[e] = sum;
  }

  // ---- 3. column slice `rank` of the output, summed over the cluster ----
  cluster.sync();
  const int E = G * kD;
  const int chunk = (E + nc - 1) / nc;
  const int e1 = min(E, (rank + 1) * chunk);
  for (int e = rank * chunk + tid; e < e1; e += kThreads) {
    float s = 0.f;
    for (int r = 0; r < nc; ++r) s += cluster.map_shared_rank(part, r)[e];
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[bh * E + e] = __float2bfloat16(s);
    else
      reinterpret_cast<float*>(out)[bh * E + e] = s;
  }
  // Peers may still read this CTA's statistics and partials.
  cluster.sync();
}

// Shared memory the kernel may ask for at most, set once per variant; 16-CTA
// clusters are above the portable size of 8.
template <int BITS, bool NEED_ATTN, int MG, bool I8>
cudaError_t prepare() {
  static bool done = false;
  if (done) return cudaSuccess;
  const void* fn = (const void*)decode_attn_kernel<BITS, NEED_ATTN, MG, I8>;
  const size_t most = layout<BITS>(MG, MG, kSmemScoreBytes / (MG * 4), true, I8).total;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  done = true;
  return cudaSuccess;
}

struct Call {
  const void *q, *kc, *vc, *ks, *kz, *vs, *vz, *mask;
  void *out, *pooled, *ws;
  int B, KVH, C, G, nc, out_bf16;
  float scale;
};

template <int BITS, bool NEED_ATTN, int MG, bool I8>
void config(const Call& a, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
            cudaStream_t st) {
  const int per = cta_slots(a.C, a.nc);
  const bool fit = scores_fit(a.G, per);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(a.nc, a.KVH, a.B);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = layout<BITS>(MG, a.G, per, fit, I8).total;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <int BITS, bool NEED_ATTN, int MG, bool I8>
int launch(const Call& a, cudaStream_t st) {
  cudaError_t e = prepare<BITS, NEED_ATTN, MG, I8>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  config<BITS, NEED_ATTN, MG, I8>(a, &cfg, attr, st);
  const int per = cta_slots(a.C, a.nc);
  e = cudaLaunchKernelEx(&cfg, decode_attn_kernel<BITS, NEED_ATTN, MG, I8>,
                         (const __nv_bfloat16*)a.q, (const uint8_t*)a.kc, (const uint8_t*)a.vc,
                         (const float*)a.ks, (const float*)a.kz, (const float*)a.vs,
                         (const float*)a.vz, (const uint8_t*)a.mask, a.out, (float*)a.pooled,
                         (float*)a.ws, a.KVH, a.C, a.G, per, (int)scores_fit(a.G, per),
                         a.out_bf16, a.scale * 1.4426950408889634f);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int BITS, bool NEED_ATTN, int MG, bool I8>
int max_clusters(const Call& a) {
  cudaError_t e = prepare<BITS, NEED_ATTN, MG, I8>();
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  config<BITS, NEED_ATTN, MG, I8>(a, &cfg, attr, 0);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, decode_attn_kernel<BITS, NEED_ATTN, MG, I8>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// Runs F<BITS, NEED_ATTN, MG, I8>(a) for the call's variant (MG: 4 for G <= 4,
// else 8); cudaErrorInvalidValue for a variant it does not have (i8dot over
// a bf16 cache).
template <template <int, bool, int, bool> class F>
int dispatch(const Call& a, int bits, int need_attn, int i8dot) {
  const bool g4 = a.G <= 4;
#define CCT_DECODE_CASE(BITS_, I8_)                                                  \
  case BITS_:                                                                        \
    if (need_attn)                                                                   \
      return g4 ? F<BITS_, true, 4, I8_>::run(a) : F<BITS_, true, 8, I8_>::run(a);   \
    return g4 ? F<BITS_, false, 4, I8_>::run(a) : F<BITS_, false, 8, I8_>::run(a);
  if (i8dot) {
    switch (bits) {
      CCT_DECODE_CASE(8, true)
      CCT_DECODE_CASE(4, true)
      CCT_DECODE_CASE(2, true)
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (bits) {
    CCT_DECODE_CASE(16, false)
    CCT_DECODE_CASE(8, false)
    CCT_DECODE_CASE(4, false)
    CCT_DECODE_CASE(2, false)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CCT_DECODE_CASE
}

cudaStream_t g_stream;

template <int BITS, bool NEED_ATTN, int MG, bool I8>
struct Launch {
  static int run(const Call& a) { return launch<BITS, NEED_ATTN, MG, I8>(a, g_stream); }
};

template <int BITS, bool NEED_ATTN, int MG, bool I8>
struct MaxClusters {
  static int run(const Call& a) { return max_clusters<BITS, NEED_ATTN, MG, I8>(a); }
};

bool valid(int B, int KVH, int C, int G, int nc) {
  return G >= 1 && G <= kMaxG && C >= 1 && B >= 1 && KVH >= 1 && nc >= 1 &&
         nc <= kMaxCluster && nc <= C;
}

}  // namespace

// Floats of global workspace for these shapes and cluster size: 0 where
// each CTA's scores fit in its shared memory, else the scores [B, KVH, G, C].
extern "C" size_t decode_attention_workspace(int B, int KVH, int C, int G, int nc) {
  if (!valid(B, KVH, C, G, nc)) return 0;
  return scores_fit(G, cta_slots(C, nc)) ? 0 : (size_t)B * KVH * G * C;
}

// Clusters of `nc` CTAs of this variant that fit on the card at once
// (cudaOccupancyMaxActiveClusters); negative on a CUDA error.
extern "C" int decode_attention_max_clusters(int B, int KVH, int C, int G, int nc, int bits,
                                             int need_attn, int i8dot) {
  if (!valid(B, KVH, C, G, nc)) return -(int)cudaErrorInvalidValue;
  Call a{};
  a.B = B;
  a.KVH = KVH;
  a.C = C;
  a.G = G;
  a.nc = nc;
  return dispatch<MaxClusters>(a, bits, need_attn, i8dot);
}

// bits: 16 (bf16 rows; scale/zero pointers unused), 8, 4 or 2.
// need_attn: write pooled [B, KVH, C] (else pooled is unused).
// i8dot: the integer branch (bits 8, 4, 2 only).
// nc: CTAs per cluster, 1..16, at most C. out: [B, H, D] in bf16 when
// out_bf16, else f32. workspace: decode_attention_workspace floats.
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* ks, const void* kz, const void* vs,
                                const void* vz, const void* mask, void* out, void* pooled,
                                void* workspace, int B, int KVH, int C, int G, int nc,
                                int bits, int need_attn, int i8dot, int out_bf16, float scale,
                                void* stream) {
  if (!valid(B, KVH, C, G, nc)) return (int)cudaErrorInvalidValue;
  Call a{q, kc, vc, ks, kz, vs, vz, mask, out, pooled, workspace,
         B, KVH, C, G, nc, out_bf16, scale};
  g_stream = (cudaStream_t)stream;
  return dispatch<Launch>(a, bits, need_attn, i8dot);
}
