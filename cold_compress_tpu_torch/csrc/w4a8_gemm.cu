// W4A8 matmul at prefill size: y[L, OUT] = x[L, IN] @ W for int4 group-wise
// weights, L large.
//
// Replaces the TPU kernels cold_compress_tpu/ops/pallas_qmm.py::
// qmm_w4a8_prefill and qmm_w4a8_prefill_cpt (_w4a8_pf_kernel(_cpt)). The
// function is the decode kernel's (w4a8_gemv.cu), on the same stored bytes
// (the "gemv" layout, w uint8 [OUT, IN/2] and sz [OUT, IN/gs] bf16 pairs),
// so the weights are held once:
//   xq, sx: each row quantized to int8 (act_quant.cuh);
//   per group g: d_g = sum xq * (q - 8) and xs_g = sum xq, exact in int32;
//   y = sx * sum_g (s_g * d_g + z_g * xs_g) in f32.
//
// Two launches per call:
//   1. w4a8_quant_kernel, one block per row: xq [L, IN] int8, sx [L] f32 and
//      the group sums xs [L, IN/gs] int32.
//   2. w4a8_gemm_kernel, one block per 128 x 128 tile of y. Each 128-input
//      step copies the tile's int8 activations and packed weight bytes to
//      shared memory with cp.async, three steps in flight; 8 warps (2 x 4,
//      64 x 32 each) load activation fragments with ldmatrix, turn each
//      weight word's nibbles into q - 8 as int8 lanes in registers, and
//      multiply on the int8 tensor cores (mma.sync m16n8k32 s8.s8.s32). The
//      int32 accumulator holds one group's exact d_g and is flushed into the
//      f32 sum as s_g * d_g + z_g * xs_g at each group boundary.
//
// Bound on this card: operations (2 * L * IN * OUT int8 multiply-adds
// against 1979 TOP/s) at L = 8192; the weights are IN * OUT / 2 bytes. No
// TMA and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"

namespace {

constexpr int kQuantWarps = 8;
constexpr int kBM = 128, kBN = 128, kBK = 128;
constexpr int kThreads = 256;          // 8 warps: 2 along M x 4 along N
constexpr int kStages = 3;             // copies in flight: 2 steps ahead
constexpr int kAStride = kBK + 16;     // activation row stride in bytes
constexpr int kBStride = kBK / 2 + 16; // packed weight column stride in bytes
constexpr int kMaxGroupsPerTile = 4;   // group size 32 at kBK = 128
constexpr int kStageBytes = kBM * kAStride + kBN * kBStride + 4 * kMaxGroupsPerTile * (kBN + kBM);

__global__ void __launch_bounds__(kQuantWarps * 32)
w4a8_quant_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                  float* __restrict__ sx, int* __restrict__ xs, int IN, int gs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kQuantWarps];
  __shared__ float s_row[1];
  int8_t* q = reinterpret_cast<int8_t*>(smem);  // [IN]
  const int row = blockIdx.x;
  quantize_rows_int8<kQuantWarps>(x, IN, row, 1, q, s_row, red);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ng = IN / gs;
  for (int g = warp; g < ng; g += kQuantWarps) {
    int acc = 0;
    for (int i = lane; i < gs; i += 32) acc += q[g * gs + i];
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) xs[(size_t)row * ng + g] = acc;
  }
  for (int i = threadIdx.x * 16; i < IN; i += kQuantWarps * 32 * 16)
    *reinterpret_cast<int4*>(xq + (size_t)row * IN + i) = *reinterpret_cast<const int4*>(q + i);
  if (threadIdx.x == 0) sx[row] = s_row[0];
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four unsigned nibbles (one per byte, 0..15) -> four int8 lanes q - 8.
__device__ __forceinline__ uint32_t nibbles_minus_8(uint32_t v) {
  return ((v | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

// Asynchronous copies global -> shared; a false predicate fills zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Fragments a0..a3 of a 16 x 32 int8 A tile (rows row0.., bytes k0..) in one
// ldmatrix.x4: lanes 0-15 address rows 0-15 at k0, lanes 16-31 at k0 + 16.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const int8_t* tile, int lane) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(
      tile + (lane & 15) * kAStride + (lane >> 4) * 16);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__global__ void __launch_bounds__(kThreads, 1)
w4a8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const int* __restrict__ xs, const uint8_t* __restrict__ w,
                 const uint32_t* __restrict__ sz, float* __restrict__ y, int L, int IN,
                 int OUT, int gs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int ng = IN / gs, IN2 = IN / 2, nk = IN / kBK;
  const int gpt = gs < kBK ? kBK / gs : 1;  // groups a tile touches

  auto stage_a = [&](int st) { return reinterpret_cast<int8_t*>(smem + st * kStageBytes); };
  auto stage_b = [&](int st) { return stage_a(st) + kBM * kAStride; };
  auto stage_sz = [&](int st) {
    return reinterpret_cast<uint32_t*>(stage_b(st) + kBN * kBStride);
  };
  auto stage_xs = [&](int st) { return reinterpret_cast<int*>(stage_sz(st) + kMaxGroupsPerTile * kBN); };

  // One 128-input step: activations (128 rows x 128 bytes), packed weights
  // (128 columns x 64 bytes), and the scales/zeros and activation group
  // sums of the groups it touches.
  auto load_stage = [&](int st, int kt) {
    const int k0 = kt * kBK, g0 = k0 / gs;
    int8_t* As = stage_a(st);
    for (int idx = tid; idx < kBM * (kBK / 16); idx += kThreads) {
      const int r = idx >> 3, ch = idx & 7;
      const bool ok = row0 + r < L;
      cp_async16(As + r * kAStride + ch * 16,
                 xq + (size_t)(ok ? row0 + r : 0) * IN + k0 + ch * 16, ok);
    }
    int8_t* Bs = stage_b(st);
    for (int idx = tid; idx < kBN * (kBK / 32); idx += kThreads) {
      const int c = idx >> 2, ch = idx & 3;
      const bool ok = col0 + c < OUT;
      cp_async16(Bs + c * kBStride + ch * 16,
                 w + (size_t)(ok ? col0 + c : 0) * IN2 + k0 / 2 + ch * 16, ok);
    }
    uint32_t* SZ = stage_sz(st);
    for (int idx = tid; idx < gpt * kBN; idx += kThreads) {
      const int gi = idx / kBN, c = idx % kBN;
      const bool ok = col0 + c < OUT;
      cp_async4(SZ + gi * kBN + c, sz + (size_t)(ok ? col0 + c : 0) * ng + g0 + gi, ok);
    }
    int* XS = stage_xs(st);
    for (int idx = tid; idx < gpt * kBM; idx += kThreads) {
      const int gi = idx / kBM, r = idx % kBM;
      const bool ok = row0 + r < L;
      cp_async4(XS + gi * kBM + r, xs + (size_t)(ok ? row0 + r : 0) * ng + g0 + gi, ok);
    }
  };

  int acc_i[4][4][4];
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc_i[mt][nt][j] = 0;
        acc[mt][nt][j] = 0.f;
      }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step kt landed; step kt - 1's buffer is free
    if (kt + kStages - 1 < nk) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();

    const int st = kt % kStages, k0 = kt * kBK;
    const int8_t* As = stage_a(st);
    const uint32_t* Bw = reinterpret_cast<const uint32_t*>(stage_b(st));
    const uint32_t* SZ = stage_sz(st);
    const int* XS = stage_xs(st);
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        load_a_frag(a[mt], As + (wm * 64 + mt * 16) * kAStride + ks * 32, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // Column n's inputs ks*32 + tig*4.. (b0) and +16 (b1): a packed word
        // covers 8 inputs, the low nibbles first.
        const uint32_t* col = Bw + (wn * 32 + nt * 8 + gid) * (kBStride / 4);
        const int sh = (tig & 1) * 4;
        const uint32_t b0 = nibbles_minus_8((col[ks * 4 + (tig >> 1)] >> sh) & 0x0F0F0F0Fu);
        const uint32_t b1 = nibbles_minus_8((col[ks * 4 + 2 + (tig >> 1)] >> sh) & 0x0F0F0F0Fu);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_s8(acc_i[mt][nt], a[mt], b0, b1);
      }
      // Group boundary after these 32 inputs: flush d_g into the f32 sum.
      if ((k0 + ks * 32 + 32) % gs == 0) {
        const int gi = gs < kBK ? (ks * 32) / gs : 0;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int ra = wm * 64 + mt * 16 + gid;
          const float xa = (float)XS[gi * kBM + ra], xb = (float)XS[gi * kBM + ra + 8];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const uint32_t v = SZ[gi * kBN + wn * 32 + nt * 8 + tig * 2 + j];
              const float s = __uint_as_float(v << 16), z = __uint_as_float(v & 0xFFFF0000u);
              acc[mt][nt][j] += s * (float)acc_i[mt][nt][j] + z * xa;
              acc[mt][nt][2 + j] += s * (float)acc_i[mt][nt][2 + j] + z * xb;
              acc_i[mt][nt][j] = 0;
              acc_i[mt][nt][2 + j] = 0;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * 64 + mt * 16 + gid + 8 * h;
      if (r >= L) continue;
      const float s = sx[r];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = col0 + wn * 32 + nt * 8 + tig * 2 + j;
          if (c < OUT) y[(size_t)r * OUT + c] = acc[mt][nt][2 * h + j] * s;
        }
      }
    }
  }
}

}  // namespace

// x bf16 [L, IN]; w uint8 [OUT, IN/2] and sz uint32 [OUT, IN/gs] (gemv
// layout); xq int8 [L, IN], sx f32 [L] and xs int32 [L, IN/gs] are
// workspace; y f32 [L, OUT]. IN % 128 == 0; gs a multiple of 32 that divides
// 128 or is a multiple of 128.
extern "C" int w4a8_gemm(const void* x, const void* w, const void* sz, void* xq, void* sx,
                         void* xs, void* y, int L, int IN, int OUT, int gs, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)IN;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        w4a8_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  w4a8_quant_kernel<<<L, kQuantWarps * 32, smem, s>>>(
      (const __nv_bfloat16*)x, (int8_t*)xq, (float*)sx, (int*)xs, IN, gs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem_gemm = kStages * kStageBytes;
  e = cudaFuncSetAttribute(w4a8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_gemm);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((OUT + kBN - 1) / kBN, (L + kBM - 1) / kBM);
  w4a8_gemm_kernel<<<grid, kThreads, smem_gemm, s>>>(
      (const int8_t*)xq, (const float*)sx, (const int*)xs, (const uint8_t*)w,
      (const uint32_t*)sz, (float*)y, L, IN, OUT, gs);
  return (int)cudaGetLastError();
}
