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
// Bound on this card: operations (2 * L * IN * OUT int8 multiply-adds
// against 1979 TOP/s) at L = 8192; the weights are IN * OUT / 2 bytes.
// What the design meets instead: the f32 flush of every group's int32 dots
// on the CUDA cores (one per 128 int8 multiply-adds of each output), which
// it shrinks to three instructions an output.
//
// Two launches per call:
//   1. w4a8_quant_kernel, one block per row: xq [L, IN] int8, sx [L] f32 and
//      the group sums xs, transposed to [IN/gs, Lp] f32 (Lp: L rounded up
//      to the tile), so that a tile's sums of one group are 512 contiguous
//      bytes, or at gs = 128 their bf16 halves [L, IN/gs] (below). Bound by
//      bytes (x read once, xq written once).
//   2. w4a8_gemm_kernel computes the transposed tile, y^T = W x^T, on
//      wgmma (m64n128k32, s8 x s8 -> s32): the weights are operand A, taken
//      from registers, the activations operand B, read from shared memory
//      by descriptor. One persistent CTA per SM walks 128 x 128 output
//      tiles (OUT x L) in the order ops/qmm.py::gemm_schedule gives (groups
//      of OUT tiles, L tiles within a group, so that the tiles in flight
//      share weights and activations in L2).
//        * Warpgroup 0 is the producer: one thread keeps a ring of kStages
//          128-input steps in flight. Each step is two TMA tensor copies
//          (xq [128 rows x 128 bytes], 128-byte swizzle as wgmma's
//          descriptor reads it; packed weights [128 columns x 64 bytes],
//          64-byte swizzle, conflict-free for the unpacking) and the tile's
//          group sums (bulk copies of xs, or at gs = 128 every eighth step
//          a TMA copy of eight groups' bf16 halves, 32-byte swizzle), all
//          completing on the step's mbarrier. It runs ahead across tiles,
//          so a tile's epilogue overlaps the next tile's loads.
//        * Warpgroups 1 and 2 are consumers, each owning 64 of the tile's
//          128 weight columns: every nibble is unpacked once per CTA tile,
//          straight from shared memory into A's register fragment (the
//          unsigned nibbles q as int8 lanes: a mask, no subtraction). A
//          group's int32 dot d'_g = sum xq * q is exact in the wgmma
//          accumulator; at each group boundary it is flushed into the f32
//          sum. s_g * d_g + z_g * xs_g (d_g = d'_g - 8 xs_g) is taken as
//          s_g * d'_g + (z_g - 8 s_g) * xs_g, the int32 -> f32 conversion
//          by the exponent trick (exact below 2**22, on the FMA pipe).
//          setmaxnreg gives each consumer thread 232 registers (the producer
//          keeps 40): two int32 accumulator sets and the f32 sums take 192.
//        * Epilogue: y = acc * sx straight from the accumulator layout to
//          global memory (each store instruction fills whole 32-byte
//          sectors), while the producer already loads the next tile.
//      At gs = 128 with IN a multiple of 1024 (the 8B shapes) each consumer
//      keeps two int32 accumulator sets, group g's wgmmas into one while
//      group g - 1's dots in the other are flushed (wgmma.wait_group 1), and
//      the zero term (z_g - 8 s_g) * xs_g goes to the tensor cores, eight
//      groups at a time as a bf16 wgmma into the f32 sums (zero_term: all
//      factors exact in bf16), so a flush is s_g * d'_g alone. ptxas keeps
//      no wgmma in flight past the next instruction here (C7515: the f32
//      sums are both a wgmma accumulator and the flush's target), so the
//      flush overlaps only the other consumer's wgmmas; measured, this
//      instance still beats one set with the zero term on the CUDA cores
//      (PERF.md, section 6). Other group
//      sizes (32, 64, multiples of 128 above it) and IN take a simpler
//      instance: one set, a wgmma wait and a flush (both terms) per group,
//      the other consumer's wgmmas running meanwhile. Every sum has a fixed
//      order: two launches give the same bits.
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the build needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"

namespace {

constexpr int kQuantThreads = 256;
constexpr int kQuantRegs = 8;          // 16-byte chunks of x a thread holds
constexpr int kBM = 128;                 // weight columns (OUT) per tile: 2 x 64
constexpr int kBN = 128;                 // activation rows (L) per tile: wgmma's N
constexpr int kBK = 128;                 // inputs per pipeline step
constexpr int kStages = 6;
constexpr int kXBytes = kBN * kBK;       // int8 activations of a step
constexpr int kWBytes = kBM * kBK / 2;   // packed weights of a step
constexpr int kMaxGroups = kBK / 32;     // groups of a step at gs = 32
// A step's activation group sums: kMaxGroups x kBN f32, or (gs = 128) the
// bf16 halves of eight groups' sums, kBN x 16.
constexpr int kXsBytes = 4096;
constexpr int kStageBytes = kXBytes + kWBytes + kXsBytes;  // 28 KB, 1 KB aligned
constexpr int kThreads = 384;            // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment slack
static_assert(kStageBytes % 1024 == 0, "stages must keep the 1 KB swizzle alignment");

// One row per block: the row's 16-byte chunks are held in registers (up to
// 16384 inputs; longer rows are read twice), its absmax reduced over the
// block, and each chunk quantized (act_quant.cuh's quant8, exact) and stored
// with its group sums: a group of gs <= 256 inputs lies in gs / 8
// consecutive lanes of one warp (a shuffle), a larger one spans warps (a
// shared-memory sum).
__global__ void __launch_bounds__(kQuantThreads)
w4a8_quant_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                  float* __restrict__ sx, float* __restrict__ xs, uint32_t* __restrict__ xsb,
                  int IN, int gs, int Lp) {
  extern __shared__ int xs_s[];  // [IN / gs], groups above 256 inputs
  __shared__ float red[kQuantThreads / 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = blockIdx.x, ng = IN / gs, nch = IN / 8;
  const int cpr = (nch + kQuantThreads - 1) / kQuantThreads;  // chunks per thread
  const bool regs = cpr <= kQuantRegs;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * IN);
  uint4 v[kQuantRegs];
  float m = 0.f;
  if (regs) {
#pragma unroll
    for (int k = 0; k < kQuantRegs; ++k) {
      const int c = tid + k * kQuantThreads;
      v[k] = (k < cpr && c < nch) ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
      m = fmaxf(m, absmax8(v[k]));
    }
  } else {
    for (int c = tid; c < nch; c += kQuantThreads) m = fmaxf(m, absmax8(__ldg(xr + c)));
  }
  if (gs > 256)
    for (int g = tid; g < ng; g += kQuantThreads) xs_s[g] = 0;
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int i = 1; i < kQuantThreads / 32; ++i) m = fmaxf(m, red[i]);
  const float s = __fmul_rn(fmaxf(m, 1e-8f), 1.0f / 127.0f), rs = __frcp_rn(s);
  const int lanes = min(gs / 8, 32);
  // A group's sum: f32 (|sum| <= 127 gs: exact) or, where asked, its bf16
  // halves sum >> 7 and sum & 127 (exact), the B operand of the zero term.
  auto put_sum = [&](int g, int sum) {
    if (xsb == nullptr) {
      xs[(size_t)g * Lp + row] = (float)sum;
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn((float)(sum >> 7), (float)(sum & 127));
      xsb[(size_t)row * ng + g] = *reinterpret_cast<const uint32_t*>(&h);
    }
  };
  auto put = [&](int c, const uint4& val) {
    int sum = 0;
    if (c < nch) {
      uint2 q;
      sum = quant8(val, s, rs, &q);
      *reinterpret_cast<uint2*>(xq + (size_t)row * IN + c * 8) = q;
    }
    for (int off = 1; off < lanes; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (c < nch && (lane & (lanes - 1)) == 0) {
      const int g = c * 8 / gs;
      if (gs <= 256) put_sum(g, sum);
      else atomicAdd(&xs_s[g], sum);  // integers: exact in any order
    }
  };
  if (regs) {
#pragma unroll
    for (int k = 0; k < kQuantRegs; ++k)
      if (k < cpr) put(tid + k * kQuantThreads, v[k]);
  } else {
    for (int k = 0; k < cpr; ++k) {
      const int c = tid + k * kQuantThreads;
      put(c, c < nch ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u));
    }
  }
  if (gs > 256) {
    __syncthreads();
    for (int g = tid; g < ng; g += kQuantThreads) put_sum(g, xs_s[g]);
  }
  if (tid == 0) sx[row] = s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One TMA tensor copy of a 2D box at (c0 inner, c1 outer), completing on bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One 1D bulk copy of `bytes` (a multiple of 16), completing on bar.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}


// wgmma descriptor of a K-major tile with 128-byte rows in the 128-byte
// swizzle (8-row atoms of 1 KB): start address, SBO = 1024 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// d (+)= A * B^T for A 64 x 32 int8 from registers (each warp's 16 rows, the
// m16n8k32 A fragment), B 128 x 32 int8 from shared memory; scale_d = 0
// overwrites d.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The step's packed weights -> A's fragment of k32 slice `sub` (unsigned
// nibbles q as int8 lanes): rows arow (a0, a2) and arow + 8 (a1, a3), inputs
// 4 tig.. and 16 + 4 tig.. of the slice, i.e. words 4 sub + tig / 2 and + 2
// of the row (low nibbles for even tig, sh = 0; high for odd, sh = 4), read
// through the 64-byte swizzle (chunk sub ^ swz).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const unsigned char* wtile, int arow,
                                       int swz, int sub, int wi, int sh) {
  const uint32_t* w0 = reinterpret_cast<const uint32_t*>(wtile + arow * 64);
  const uint32_t* w1 = w0 + 8 * 16;
  const int c = (sub ^ swz) << 2;
  a[0] = (w0[c + wi] >> sh) & 0x0F0F0F0Fu;
  a[1] = (w1[c + wi] >> sh) & 0x0F0F0F0Fu;
  a[2] = (w0[c + 2 + wi] >> sh) & 0x0F0F0F0Fu;
  a[3] = (w1[c + 2 + wi] >> sh) & 0x0F0F0F0Fu;
}

// d += A * B^T in f32 for A 64 x 16 bf16 from registers, B 128 x 16 bf16
// from shared memory (K-major).
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// wgmma descriptor of a K-major tile with 32-byte rows in the 32-byte
// swizzle (8-row atoms of 256 bytes).
__device__ __forceinline__ uint64_t desc_sw32(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

// Two bf16 in one register: lo in the low half (the lower k).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The zero term of eight groups g0..g0+7 on the tensor cores: sum_g (z_g -
// 8 s_g) xs_g, with xs_g = 128 xh_g + xl_g (its bf16 halves, B from shared
// memory) and A = [128 z_g, z_g] and [-1024 s_g, -8 s_g] from registers:
// every factor is exact in bf16 and every product exact in f32. This
// thread's A rows r0 (a0, a2) and r1 (a1, a3), k pairs 2 tig.. (group g0 +
// tig) and 8 + 2 tig.. (group g0 + 4 + tig).
__device__ __forceinline__ void zero_term(float (&acc)[64], const uint32_t* __restrict__ sz, int r0,
                                          int r1, int OUT, int ng, int g0, int tig,
                                          uint64_t desc) {
  uint32_t w[4];  // (r0, ga), (r1, ga), (r0, gb), (r1, gb)
  const int ga = g0 + tig, gb = g0 + 4 + tig;
  w[0] = r0 < OUT ? __ldg(sz + (size_t)r0 * ng + ga) : 0u;
  w[1] = r1 < OUT ? __ldg(sz + (size_t)r1 * ng + ga) : 0u;
  w[2] = r0 < OUT ? __ldg(sz + (size_t)r0 * ng + gb) : 0u;
  w[3] = r1 < OUT ? __ldg(sz + (size_t)r1 * ng + gb) : 0u;
  uint32_t az[4], as[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float z = __uint_as_float(w[i] & 0xFFFF0000u), sc = __uint_as_float(w[i] << 16);
    az[i] = pack_bf16(128.f * z, z);
    as[i] = pack_bf16(-1024.f * sc, -8.f * sc);
  }
  wgmma_fence();  // after the last flush's writes to acc and these A registers
  wgmma_bf16(acc, az, desc);
  wgmma_bf16(acc, as, desc);
}

// Keeps the compiler from moving reads of the accumulator above the wait.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Tile t of the schedule -> (weight-column tile, activation-row tile):
// groups of `group` column tiles, the row tiles in order within a group.
// ops/qmm.py::gemm_tile computes the same.
__device__ __forceinline__ void tile_coords(int t, int n_out, int n_rows, int group, int& ot,
                                            int& lt) {
  const int per = group * n_rows;
  const int g = t / per, i = t - g * per;
  const int width = min(group, n_out - g * group);
  ot = g * group + i % width;
  lt = i / width;
}

// Folds one group's exact int32 dots into the f32 sums, for this thread's two
// weight columns and 32 activation rows. The dots are d' = sum xq * q with
// the unsigned nibbles q (A holds q, not q - 8), so s * d + z * xs (d =
// d' - 8 xs) is taken as s * d' + (z - 8 s) * xs.
// Below 2**22, float(d) is the bits of 1.5 * 2**23 + d as a float minus
// 1.5 * 2**23, and fma(s, 1.5 * 2**23 + d, -1.5 * 2**23 * s) (the last
// product exact: s has 8 significant bits) rounds s * d once, as s *
// float(d) does. Larger groups (gs > 2048) convert with I2F.
__device__ __forceinline__ void flush_group(float (&acc)[64], const int (&d)[64], uint32_t sz0,
                                            uint32_t sz1, const float* xsv, int tig, bool big) {
  const float s0 = __uint_as_float(sz0 << 16), s1 = __uint_as_float(sz1 << 16);
  const float z0 = __uint_as_float(sz0 & 0xFFFF0000u) - 8.f * s0;
  const float z1 = __uint_as_float(sz1 & 0xFFFF0000u) - 8.f * s1;
  if (!big) {
    const float m0 = -s0 * 12582912.0f, m1 = -s1 * 12582912.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 xv = *reinterpret_cast<const float2*>(xsv + 8 * j + 2 * tig);
      acc[4 * j + 0] = fmaf(z0, xv.x, acc[4 * j + 0] + fmaf(s0, __int_as_float(d[4 * j + 0] + 0x4B400000), m0));
      acc[4 * j + 1] = fmaf(z0, xv.y, acc[4 * j + 1] + fmaf(s0, __int_as_float(d[4 * j + 1] + 0x4B400000), m0));
      acc[4 * j + 2] = fmaf(z1, xv.x, acc[4 * j + 2] + fmaf(s1, __int_as_float(d[4 * j + 2] + 0x4B400000), m1));
      acc[4 * j + 3] = fmaf(z1, xv.y, acc[4 * j + 3] + fmaf(s1, __int_as_float(d[4 * j + 3] + 0x4B400000), m1));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 xv = *reinterpret_cast<const float2*>(xsv + 8 * j + 2 * tig);
      acc[4 * j + 0] = fmaf(z0, xv.x, acc[4 * j + 0] + s0 * (float)d[4 * j + 0]);
      acc[4 * j + 1] = fmaf(z0, xv.y, acc[4 * j + 1] + s0 * (float)d[4 * j + 1]);
      acc[4 * j + 2] = fmaf(z1, xv.x, acc[4 * j + 2] + s1 * (float)d[4 * j + 2]);
      acc[4 * j + 3] = fmaf(z1, xv.y, acc[4 * j + 3] + s1 * (float)d[4 * j + 3]);
    }
  }
}

// The integer term alone, acc += s * d' (gs = 128: the zero term goes to the
// tensor cores, zero_term).
__device__ __forceinline__ void flush_int(float (&acc)[64], const int (&d)[64], uint32_t sz0,
                                          uint32_t sz1) {
  const float s0 = __uint_as_float(sz0 << 16), s1 = __uint_as_float(sz1 << 16);
  const float m0 = -s0 * 12582912.0f, m1 = -s1 * 12582912.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[4 * j + 0] += fmaf(s0, __int_as_float(d[4 * j + 0] + 0x4B400000), m0);
    acc[4 * j + 1] += fmaf(s0, __int_as_float(d[4 * j + 1] + 0x4B400000), m0);
    acc[4 * j + 2] += fmaf(s1, __int_as_float(d[4 * j + 2] + 0x4B400000), m1);
    acc[4 * j + 3] += fmaf(s1, __int_as_float(d[4 * j + 3] + 0x4B400000), m1);
  }
}

// KPG: k32 steps per group within a 128-input step (4 for gs >= 128, 2 for
// 64, 1 for 32); PIPE: gs = 128 with IN a multiple of 1024, on two
// accumulator sets, the zero term on the tensor cores.
template <int KPG, bool PIPE>
__global__ void __launch_bounds__(kThreads, 1)
w4a8_gemm_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_xsb, const float* __restrict__ xs, const float* __restrict__ sx,
                 const uint32_t* __restrict__ sz, float* __restrict__ y, int L, int IN, int OUT,
                 int gs, int Lp, int group) {
  constexpr int GPT = 4 / KPG;  // groups per step (1 above 128 inputs)
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  extern __shared__ unsigned char smem_raw[];
  // The swizzled tiles need 1 KB alignment.
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_out = (OUT + kBM - 1) / kBM, n_rows = (L + kBN - 1) / kBN;
  const int tiles = n_out * n_rows, nk = IN / kBK, ng = IN / gs;
  const int spg = gs > kBK ? gs / kBK : 1;  // steps per group

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      const uint32_t step_tx = kXBytes + kWBytes + (PIPE ? 0 : GPT * kBN * 4);
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int ot, lt;
        tile_coords(t, n_out, n_rows, group, ot, lt);
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);  // the consumers freed the slot
          const uint32_t bar = smem_u32(&full[stage]);
          const uint32_t st = sbase + stage * kStageBytes;
          // At gs = 128, every eighth step also brings the bf16 halves of
          // eight groups' sums [128 rows x 16] (the zero term's B).
          const bool zstep = PIPE && kt % 8 == 0;
          mbar_expect(bar, step_tx + (zstep ? kBN * 32 : 0));
          tma_load_2d(st, &tm_x, kt * kBK, lt * kBN, bar);
          tma_load_2d(st + kXBytes, &tm_w, kt * (kBK / 2), ot * kBM, bar);
          if (zstep) tma_load_2d(st + kXBytes + kWBytes, &tm_xsb, 2 * kt, lt * kBN, bar);
          if (!PIPE) {
            const int g0 = gs <= kBK ? kt * GPT : kt / spg;
#pragma unroll
            for (int q = 0; q < GPT; ++q)
              bulk_copy(st + kXBytes + kWBytes + q * kBN * 4,
                        xs + (size_t)(g0 + q) * Lp + lt * kBN, kBN * 4, bar);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 weight columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cw = (warp >> 2) - 1, wl = warp & 3;
    const int gid = lane >> 2, tig = lane & 3;
    const int arow = cw * 64 + wl * 16 + gid;  // this thread's A rows: arow, arow + 8
    const int swz = (arow >> 1) & 3;           // their 64-byte swizzle (the same for both)
    const int sh = (tig & 1) * 4, wi = tig >> 1;
    const bool big = gs > 2048;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int ot, lt;
      tile_coords(t, n_out, n_rows, group, ot, lt);
      const int r0 = ot * kBM + arow, r1 = r0 + 8;
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      auto release = [&](int st) {
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
      };
      if constexpr (PIPE) {
        // Groups of 128 inputs (one per step) on two accumulator sets: group
        // g's wgmmas go into one while group g - 1's dots in the other are
        // flushed (wgmma.wait_group 1); every eighth step first puts eight
        // groups' zero terms into the f32 sums on the tensor cores (their own
        // commit group, done by the next wait). The straight-line step (a
        // macro over a pair of groups) keeps ptxas from serializing on the
        // d registers (C7514); the shared f32 sums still make it (C7515).
        int d0[64], d1[64];
        int pstage = 0;                 // the step of the group to flush next
        uint32_t psz0 = 0u, psz1 = 0u;  // and its scales/zeros
#define K8_GROUP(DC, DP, G)                                                                 \
  {                                                                                         \
    const uint32_t gsz0 = r0 < OUT ? __ldg(sz + (size_t)r0 * ng + (G)) : 0u;                \
    const uint32_t gsz1 = r1 < OUT ? __ldg(sz + (size_t)r1 * ng + (G)) : 0u;                \
    mbar_wait(smem_u32(&full[stage]), phase);                                               \
    const unsigned char* st = smem + stage * kStageBytes;                                   \
    const uint64_t desc = desc_sw128(sbase + stage * kStageBytes);                          \
    if ((G) % 8 == 0) {                                                                     \
      zero_term(acc, sz, r0, r1, OUT, ng, (G), tig,                                         \
                desc_sw32(sbase + stage * kStageBytes + kXBytes + kWBytes));                \
      wgmma_commit();                                                                       \
    }                                                                                       \
    _Pragma("unroll") for (int sub = 0; sub < 4; ++sub) {                                   \
      uint32_t a[4];                                                                        \
      load_a(a, st + kXBytes, arow, swz, sub, wi, sh);                                      \
      wgmma_fence();                                                                        \
      wgmma_s8(DC, a, desc + 2 * sub, sub == 0 ? 0 : 1);                                    \
    }                                                                                       \
    wgmma_commit();                                                                         \
    wgmma_wait1();                                                                          \
    fence_acc(DP);                                                                          \
    fence_acc(acc);                                                                         \
    if ((G) > 0) {                                                                          \
      flush_int(acc, DP, psz0, psz1);                                                       \
      release(pstage);                                                                      \
    }                                                                                       \
    psz0 = gsz0;                                                                            \
    psz1 = gsz1;                                                                            \
    pstage = stage;                                                                         \
    if (++stage == kStages) {                                                               \
      stage = 0;                                                                            \
      phase ^= 1;                                                                           \
    }                                                                                       \
  }
        for (int g = 0; g < ng; g += 2) {
          K8_GROUP(d0, d1, g)
          K8_GROUP(d1, d0, g + 1)
        }
        // ng is a multiple of 8, so the last group is in d1.
        wgmma_wait0();
        fence_acc(d1);
        fence_acc(acc);
        flush_int(acc, d1, psz0, psz1);
#undef K8_GROUP
        release(pstage);
      } else {
        // Groups of 32, 64 or more than 128 inputs on one accumulator set: a
        // group is flushed as soon as its wgmmas are done (the other
        // consumer's run meanwhile).
        int d[64];
        for (int kt = 0; kt < nk; ++kt) {
          const int g0 = gs <= kBK ? kt * GPT : kt / spg;
          const bool first = gs <= kBK || kt % spg == 0;    // the step starts its group
          const bool last = gs <= kBK || kt % spg == spg - 1;  // and ends it
          // Scales and zeros of the step's groups (read from L2 while the
          // step's copies land).
          uint32_t sz0[GPT], sz1[GPT];
#pragma unroll
          for (int q = 0; q < GPT; ++q) {
            sz0[q] = (last && r0 < OUT) ? __ldg(sz + (size_t)r0 * ng + g0 + q) : 0u;
            sz1[q] = (last && r1 < OUT) ? __ldg(sz + (size_t)r1 * ng + g0 + q) : 0u;
          }
          mbar_wait(smem_u32(&full[stage]), phase);
          const unsigned char* st = smem + stage * kStageBytes;
          const uint64_t desc = desc_sw128(sbase + stage * kStageBytes);
          const float* xsv = reinterpret_cast<const float*>(st + kXBytes + kWBytes);
#pragma unroll
          for (int q = 0; q < GPT; ++q) {
            uint32_t a[KPG][4];
#pragma unroll
            for (int k = 0; k < KPG; ++k) load_a(a[k], st + kXBytes, arow, swz, q * KPG + k, wi, sh);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < KPG; ++k)
              wgmma_s8(d, a[k], desc + 2 * (q * KPG + k), (k == 0 && first) ? 0 : 1);
            wgmma_commit();
            wgmma_wait0();
            fence_acc(d);
            if (last) flush_group(acc, d, sz0[q], sz1[q], xsv + q * kBN, tig, big);
          }
          release(stage);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // ---- epilogue: y[l, r] = acc * sx[l] ----
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int l = lt * kBN + 8 * j + 2 * tig + h;
          if (l < L) {
            const float sv = __ldg(sx + l);
            float* yr = y + (size_t)l * OUT;
            if (r0 < OUT) yr[r0] = acc[4 * j + h] * sv;
            if (r1 < OUT) yr[r1] = acc[4 * j + 2 + h] * sv;
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A 2D tensor map over [outer, inner] elements of `esize` bytes (rows
// contiguous), of type `type`.
int encode_2d(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
              uint32_t box_inner, uint32_t box_outer, CUtensorMapSwizzle swizzle,
              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_UINT8, int esize = 1) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * esize};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int KPG, bool PIPE>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& tz, const void* xs,
           const void* sx,
           const void* sz, void* y, int L, int IN, int OUT, int gs, int Lp, int ctas, int group,
           cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(w4a8_gemm_kernel<KPG, PIPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  w4a8_gemm_kernel<KPG, PIPE><<<ctas, kThreads, kSmem, st>>>(
      tx, tw, tz, (const float*)xs, (const float*)sx, (const uint32_t*)sz, (float*)y, L, IN, OUT, gs,
      Lp, group);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [L, IN] -> xq int8 [L, IN], sx f32 [L], and the group sums: if xsb
// is null, xs f32 [IN/gs, Lp] (transposed; columns L.. are not written),
// else xsb [L, IN/gs] pairs of bf16 (sum >> 7, sum & 127).
extern "C" int w4a8_gemm_quant(const void* x, void* xq, void* sx, void* xs, void* xsb, int L,
                               int IN, int gs, int Lp, void* stream) {
  if (L < 1 || IN % 16 || gs % 32 || IN % gs || Lp < L) return (int)cudaErrorInvalidValue;
  const size_t smem = gs > 256 ? (size_t)(IN / gs) * 4 : 0;
  w4a8_quant_kernel<<<L, kQuantThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (int8_t*)xq, (float*)sx, (float*)xs, (uint32_t*)xsb, IN, gs, Lp);
  return (int)cudaGetLastError();
}

// xq/sx and xs or xsb from w4a8_gemm_quant (xsb: gs = 128 with IN % 1024 ==
// 0, the instance with the zero term on the tensor cores; xs otherwise); w uint8
// [OUT, IN/2] and sz uint32 [OUT, IN/gs] (gemv layout); y f32 [L, OUT].
// IN % 128 == 0; gs a multiple of 32 that divides 128 or is a multiple of
// 128; Lp a multiple of 128; ctas CTAs walk the tiles in groups of `group`
// weight-column tiles (ops/qmm.py::gemm_schedule).
extern "C" int w4a8_gemm(const void* xq, const void* sx, const void* xs, const void* xsb,
                         const void* w, const void* sz, void* y, int L, int IN, int OUT, int gs,
                         int Lp, int ctas, int group, void* stream) {
  if (L < 1 || OUT < 1 || IN < kBK || IN % kBK || gs % 32 || (kBK % gs && gs % kBK) ||
      IN % gs || Lp % kBN || Lp < L || ctas < 1 || group < 1)
    return (int)cudaErrorInvalidValue;
  const bool pipe = gs == kBK && IN % (8 * kBK) == 0;
  if (pipe ? xsb == nullptr : xs == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw, tz = {};
  int e = encode_2d(&tx, xq, IN, L, kBK, kBN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  e = encode_2d(&tw, w, IN / 2, OUT, kBK / 2, kBM, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e) return e;
  if (pipe) {
    e = encode_2d(&tz, xsb, 2 * (IN / gs), L, 16, kBN, CU_TENSOR_MAP_SWIZZLE_32B,
                  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2);
    if (e) return e;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (pipe) return launch<4, true>(tx, tw, tz, xs, sx, sz, y, L, IN, OUT, gs, Lp, ctas, group, st);
  switch (gs) {
    case 32: return launch<1, false>(tx, tw, tz, xs, sx, sz, y, L, IN, OUT, gs, Lp, ctas, group, st);
    case 64: return launch<2, false>(tx, tw, tz, xs, sx, sz, y, L, IN, OUT, gs, Lp, ctas, group, st);
    default: return launch<4, false>(tx, tw, tz, xs, sx, sz, y, L, IN, OUT, gs, Lp, ctas, group, st);
  }
}
