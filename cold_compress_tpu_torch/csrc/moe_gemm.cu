// Grouped int4 GEMM over the experts of a prefill (a mixture of experts'
// MLP over many rows) and its weighted combine: three launches a layer, no
// host read.
//
// Replaces no TPU kernel (the JAX package has no expert layer). ops/moe.py
// sorts the N K (token, expert) pairs by expert on the card (stable: each
// expert's rows keep token order) and builds a tile schedule, a list of
// (expert, first sorted row, rows <= kBN) tiles with the unused slots at the
// end (rows 0); all three launches read it from device memory.
//
//   moe_gemm_kernel<true> (gate and up, with SwiGLU): for every sorted row r
//     of expert e, h[r] = silu(bf16(x[src[r]] W13_e)) * bf16(x[src[r]] W13'_e),
//     the gate and up products rounded to bf16, silu in f32 to bf16 and the
//     product to bf16 (ops/moe.py::swiglu_pairs' roundings). The token rows
//     are gathered by index as they are loaded; the [rows, 2F] products are
//     never written.
//   moe_gemm_kernel<false> (down): y[pair[r]] = bf16(h[r] W2_e), each row
//     written straight to its pair's place in [N, K, D].
//   moe_combine_kernel: out[n] = bf16(sum_k w[n, k] * y[n, k]), each product
//     and sum rounded in f32 in k order (ops/moe.py::combine).
//
// The weights are the experts' stored int4 leaves in the decode GEMV's
// "gemv" layout (w uint8 [E, OUT, IN/2], sz [E, OUT, IN/gs] bf16 pairs;
// gate and up interleaved, column 2j gate j, 2j + 1 up j), dequantized in
// registers with ops/qmm.py::dequantize_gemv's arithmetic and bits: (q - 8)
// * s + z in f32 (the product is exact: an integer of 4 bits times an 8-bit
// scale, so one rounding of the sum), then one rounding to bf16. The
// products are bf16 x bf16 with f32 sums, as the eager matmuls over the
// dequantized weights; only the order of each f32 sum differs.
//
// Bound on this card: operations (2 N K 3 D F bf16 multiply-adds against
// 989 TFLOP/s; Mellum2's 4 x 16256 rows take 182 ms a call of 28 layers).
// What the design meets instead (scripts/torch_moe_gemm_ablation.py): the
// gather (the gate/up launch's 16-byte copies, re-read by each of a token
// tile's column tiles), the int4 -> bf16 conversion on the CUDA cores (nine
// instructions a pair of weights, once per 256 token rows), and SwiGLU's
// exp and division in the epilogue.
//
// The GEMM computes the transposed tile, y^T = W x^T, on wgmma
// (m64n256k16, bf16 x bf16 -> f32): the weights are operand A, dequantized
// from shared memory into registers, the token rows operand B, read from
// shared memory by descriptor. One persistent CTA per SM walks (tile, weight
// column tile) items, the column tiles of one token tile on neighbouring
// CTAs, so that a token tile's rows are read from L2 while the expert's
// columns stream past.
//   * Warpgroup 0 is the producer. Thread 0 brings each step's packed
//     weights [128 columns x 32 bytes] by a TMA tensor copy, and in the down
//     launch the step's sorted h rows [256 rows x 64 inputs] by another. In
//     the gate/up launch all 128 threads gather the step's token rows by
//     index with 16-byte cp.async copies, zero past the tile's rows, into the
//     128-byte swizzle that wgmma's descriptor reads; each thread's copies
//     arrive on the stage's mbarrier as they land, and a consumer fences the
//     proxies before its wgmmas read them.
//   * Warpgroups 1 and 2 are consumers, 64 weight columns each. Each thread
//     dequantizes its two A rows of a 64-input step (16 bf16 pairs) while the
//     previous step's wgmmas run (two A register sets), then issues the
//     step's four wgmmas. The gate/up launch gives a thread's rows gid and
//     gid + 8 the gate and up column of one h column, so that SwiGLU's pair
//     meets in one thread's accumulators.
//   * The epilogue stages bf16 h (or y) token-major in shared memory
//     (stmatrix) and stores each token's piece with a bulk copy that runs on
//     while the next item's steps do; masked at the tile's rows. Every sum
//     has a fixed order: two launches give the same bits.
//
// A cluster of two CTAs forwarding each other half of the gathered rows
// (distributed shared memory) halved the gather and measured slower: the
// cross-CTA barriers cost more than the copies saved (PERF.md, section 6).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                 // weight columns (OUT) per item: 2 x 64
constexpr int kBN = 256;                 // token rows per tile: wgmma's N (ops/moe.py::TILE_ROWS)
constexpr int kBK = 64;                  // inputs per pipeline step: one 128-byte bf16 row
constexpr int kXBytes = kBN * kBK * 2;   // token rows of a step
constexpr int kWBytes = kBM * kBK / 2;   // packed weights of a step
constexpr int kStageBytes = kXBytes + kWBytes;  // 36 KB, 1 KB aligned
constexpr int kThreads = 384;            // producer + two consumer warpgroups
constexpr int kProducers = 128;
constexpr int kConsumerWarps = 8;
constexpr int kMaxStages = 5;
constexpr int kCombineThreads = 256;
static_assert(kStageBytes % 1024 == 0, "stages must keep the 1 KB swizzle alignment");

// Pipeline stages and each consumer warpgroup's epilogue buffer: a staged
// token row is its 64-byte (h) or 128-byte (y) piece and 16 bytes of
// padding, so that 8 consecutive tokens' 16-byte chunks fall in distinct
// banks; the down launch's wider rows leave room for one stage fewer.
template <bool SWIGLU>
struct Layout {
  static constexpr int kStages = SWIGLU ? 5 : 4;
  static constexpr int kEpRow = SWIGLU ? 80 : 144;
  static constexpr int kEpBytes = kBN * kEpRow;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kEpBytes + 1024;  // + alignment slack
};
static_assert(Layout<true>::kStages <= kMaxStages && Layout<false>::kStages <= kMaxStages, "");
static_assert(Layout<true>::kSmem + 2048 <= 232448 && Layout<false>::kSmem + 2048 <= 232448,
              "shared memory of one CTA");

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

// The generic proxy's writes (cp.async, stmatrix) before the async proxy's
// reads (wgmma, the bulk stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// 16 bytes from global to shared memory; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// The stage's barrier receives one arrival once every cp.async this thread
// issued before has landed (the barrier's count includes it).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kProducers) : "memory");
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

// d (+)= A * B^T in f32 for A 64 x 16 bf16 from registers (each warp's 16
// rows, the m16n8k16 A fragment), B 256 x 16 bf16 from shared memory
// (K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}"
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
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Keep the compiler from moving reads of the accumulator above the wait,
// and from reusing an A register set before the wgmmas that read it are done.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
}

// Two bf16 in one register: lo in the low half (the lower k).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Inputs 2 tig and 2 tig + 1 of a word's eight (low nibbles of bytes 0..3
// are inputs 0..3, high nibbles 4..7; `sh` = 16 (tig & 1) + 4 (tig >> 1)
// brings the pair to bits 0..3 and 8..11) -> bf16x2, as
// qmm.dequantize_gemv: (q - 8) * s + z in f32, then bf16. 2**23 + q as a
// float minus 2**23 + 8 is q - 8, exactly; (q - 8) * s is exact in f32 (a
// 4-bit integer times an 8-bit significand), so the fused multiply-add
// rounds once where dequantize_gemv's add does: the same bits.
__device__ __forceinline__ uint32_t dq2(uint32_t word, int sh, float s, float z) {
  const uint32_t v = word >> sh;
  const float q0 = __fsub_rn(__uint_as_float(0x4B000000u | (v & 0xFu)), 8388616.0f);
  const float q1 = __fsub_rn(__uint_as_float(0x4B000000u | ((v >> 8) & 0xFu)), 8388616.0f);
  return pack_bf16(__fmaf_rn(q0, s, z), __fmaf_rn(q1, s, z));
}

// One 64-input step of this thread's A rows ra and rb (32 packed bytes
// each in the step's weight tile) -> the four k16 slices' fragments: a[s]
// = (ra, k 2 tig..), (rb, k 2 tig..), (ra, k 8 + 2 tig..), (rb, 8 + 2 tig..)
// of inputs 16 s.., i.e. words 2 s and 2 s + 1 of each row.
__device__ __forceinline__ void dequant_step(uint32_t (&a)[4][4], const unsigned char* wtile,
                                             int ra, int rb, int sh, uint32_t sza, uint32_t szb) {
  const uint4* pa = reinterpret_cast<const uint4*>(wtile + ra * (kBK / 2));
  const uint4* pb = reinterpret_cast<const uint4*>(wtile + rb * (kBK / 2));
  const uint4 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
  const uint32_t wa[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const uint32_t wb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const float sa = __uint_as_float(sza << 16), za = __uint_as_float(sza & 0xFFFF0000u);
  const float sb = __uint_as_float(szb << 16), zb = __uint_as_float(szb & 0xFFFF0000u);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s][0] = dq2(wa[2 * s], sh, sa, za);
    a[s][1] = dq2(wb[2 * s], sh, sb, zb);
    a[s][2] = dq2(wa[2 * s + 1], sh, sa, za);
    a[s][3] = dq2(wb[2 * s + 1], sh, sb, zb);
  }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// silu in f32 as PyTorch's eager kernel computes it: x / (1 + exp(-x)).
__device__ __forceinline__ float silu(float v) { return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v))); }

// SwiGLU of one (gate, up) pair of f32 sums, rounded as swiglu_pairs rounds
// (the products to bf16, silu in f32 to bf16, the product to bf16).
__device__ __forceinline__ float swiglu(float gate, float up) {
  const float g = bf16_round(gate), u = bf16_round(up);
  return bf16_round(bf16_round(silu(g)) * u);
}

// Four 8x8 bf16 matrices (this thread's fragment registers, rows of the
// accumulator's M) stored transposed: lane l gives the address of row l & 7
// of matrix l >> 3, which receives that column's 8 values (16 bytes).
__device__ __forceinline__ void stmatrix_t4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// `bytes` (a multiple of 16) from shared to global memory in the background,
// in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// This thread's bulk stores have read their sources (or, bulk_wait, are done).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The 128 threads of consumer warpgroup cw (named barriers 2 and 3).
__device__ __forceinline__ void consumer_sync(int cw) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + cw) : "memory");
}

// SWIGLU: the gate/up launch (x rows gathered by rowmap, h [rows, OUT / 2]
// out); else the down launch (x the sorted h rows, y [N K, OUT] out at the
// rows rowmap gives).
template <bool SWIGLU>
__global__ void __launch_bounds__(kThreads, 1)
moe_gemm_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
                const __nv_bfloat16* __restrict__ x,
                const int* __restrict__ rowmap, const int* __restrict__ tiles,
                const uint32_t* __restrict__ sz, __nv_bfloat16* __restrict__ out, int n_items,
                int IN, int OUT, int gs) {
  constexpr int kStages = Layout<SWIGLU>::kStages, kEpRow = Layout<SWIGLU>::kEpRow;
  constexpr int kEpBytes = Layout<SWIGLU>::kEpBytes;
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ int row_src[kBN];  // the producer's source row of each tile row (-1: none)
  extern __shared__ unsigned char smem_raw[];
  // The swizzled tiles need 1 KB alignment.
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_col = OUT / kBM, nk = IN / kBK, ng = IN / gs;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // gate/up: every producer's copies + the TMA's expect; down: the expect
      mbar_init(smem_u32(&full[s]), SWIGLU ? kProducers + 1 : 1);
      mbar_init(smem_u32(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (SWIGLU || tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      const int c = tid & 7;  // this thread's 16-byte chunk of each row it gathers
      for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
        const int slot = it / n_col, ct = it - slot * n_col;
        const int e = __ldg(tiles + 3 * slot), first = __ldg(tiles + 3 * slot + 1);
        const int rows = __ldg(tiles + 3 * slot + 2);
        if (rows <= 0) break;  // the unused slots are the last
        if (SWIGLU) {
          producer_sync();  // every thread is done with the last item's rows
          for (int r = tid; r < kBN; r += kProducers)
            row_src[r] = r < rows ? __ldg(rowmap + first + r) : -1;
          producer_sync();
        }
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);  // the consumers freed the slot
          const uint32_t bar = smem_u32(&full[stage]);
          const uint32_t st = sbase + stage * kStageBytes;
          if (tid == 0) {
            mbar_expect(bar, kWBytes + (SWIGLU ? 0 : kXBytes));
            tma_load_2d(st + kXBytes, &tm_w, kt * (kBK / 2), e * OUT + ct * kBM, bar);
            if (!SWIGLU) tma_load_2d(st, &tm_x, kt * kBK, first, bar);
          }
          if (SWIGLU) {
#pragma unroll 4
            for (int i = 0; i < kBN * 8 / kProducers; ++i) {
              const int r = (tid >> 3) + i * (kProducers / 8);
              const int src = row_src[r];
              const __nv_bfloat16* g = x + (size_t)(src < 0 ? 0 : src) * IN + kt * kBK + c * 8;
              cp_async16(st + r * 128 + ((c ^ (r & 7)) << 4), g, src < 0 ? 0 : 16);
            }
            cp_async_arrive(bar);  // arrives once this thread's copies have landed
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      if (SWIGLU) cp_async_wait_all();
    }
  } else {
    // ---- consumer warpgroups: 64 weight columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cw = (warp >> 2) - 1, wl = warp & 3;
    const int gid = lane >> 2, tig = lane & 3;
    const int sh = 16 * (tig & 1) + 4 * (tig >> 1);
    // This thread's A rows (of the item's 128 weight columns): gate and up
    // of one h column for SwiGLU, rows gid and gid + 8 of the warp's 16 else.
    const int base = cw * 64 + wl * 16;
    const int ra = SWIGLU ? base + 2 * gid : base + gid;
    const int rb = SWIGLU ? ra + 1 : ra + 8;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
      const int slot = it / n_col, ct = it - slot * n_col;
      const int e = __ldg(tiles + 3 * slot), first = __ldg(tiles + 3 * slot + 1);
      const int rows = __ldg(tiles + 3 * slot + 2);
      if (rows <= 0) break;
      const uint32_t* sza = sz + (size_t)(e * OUT + ct * kBM + ra) * ng;
      const uint32_t* szb = sz + (size_t)(e * OUT + ct * kBM + rb) * ng;
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      uint32_t a0[4][4], a1[4][4];
      mbar_wait(smem_u32(&full[stage]), phase);
      dequant_step(a0, smem + stage * kStageBytes + kXBytes, ra, rb, sh, __ldg(sza), __ldg(szb));
      // One step (a macro: the accumulators and both A sets stay in
      // registers): the wgmmas of step KT over CUR, then, while they run,
      // the next step's weights into NXT; the stage is released once the
      // wgmmas that read it are done.
#define MOE_STEP(CUR, NXT, KT)                                                               \
  {                                                                                          \
    const bool more = (KT) + 1 < nk;                                                         \
    uint32_t na = 0u, nb = 0u;                                                               \
    if (more) {                                                                              \
      const int g = ((KT) + 1) * kBK / gs;                                                   \
      na = __ldg(sza + g);                                                                   \
      nb = __ldg(szb + g);                                                                   \
    }                                                                                        \
    const uint64_t desc = desc_sw128(sbase + stage * kStageBytes);                           \
    if (SWIGLU) fence_proxy_async(); /* the gathered rows (cp.async) before wgmma reads */   \
    wgmma_fence();                                                                           \
    _Pragma("unroll") for (int s = 0; s < 4; ++s)                                            \
        wgmma_n256(acc, CUR[s], desc + 2 * s, ((KT) | s) != 0);                              \
    wgmma_commit();                                                                          \
    int nstage = stage + 1;                                                                  \
    uint32_t nphase = phase;                                                                 \
    if (nstage == kStages) {                                                                 \
      nstage = 0;                                                                            \
      nphase ^= 1;                                                                           \
    }                                                                                        \
    if (more) {                                                                              \
      mbar_wait(smem_u32(&full[nstage]), nphase);                                            \
      dequant_step(NXT, smem + nstage * kStageBytes + kXBytes, ra, rb, sh, na, nb);          \
    }                                                                                        \
    wgmma_wait0();                                                                           \
    fence_a(CUR);                                                                            \
    fence_acc(acc);                                                                          \
    __syncwarp();                                                                            \
    if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));                                     \
    stage = nstage;                                                                          \
    phase = nphase;                                                                          \
  }
      for (int kt = 0; kt < nk; kt += 2) {
        MOE_STEP(a0, a1, kt)
        if (kt + 1 < nk) MOE_STEP(a1, a0, kt + 1)
      }
#undef MOE_STEP
      // ---- epilogue: accumulator (weight column, token row) -> bf16 ----
      // Staged in this warpgroup's buffer token-major (stmatrix .trans: a
      // warp's 8 columns of a token per 16 bytes), then each token's piece
      // (64 bytes of h, 128 of y) stored by a bulk copy that runs on while
      // the next item's steps do; masked at the tile's rows.
      const uint32_t ep_s = sbase + kStages * kStageBytes + cw * kEpBytes;
      const int wt = tid - 128 * (cw + 1);  // thread of the warpgroup
      const int q = lane >> 3, r8 = lane & 7;
      bulk_wait_read();  // this thread's stores of the last item have read the buffer
      consumer_sync(cw);
      if (SWIGLU) {
#pragma unroll
        for (int j = 0; j < 32; j += 4) {
          uint32_t hv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int jj = j + i;
            hv[i] = pack_bf16(swiglu(acc[4 * jj], acc[4 * jj + 2]),
                              swiglu(acc[4 * jj + 1], acc[4 * jj + 3]));
          }
          stmatrix_t4(ep_s + (8 * (j + q) + r8) * kEpRow + wl * 16, hv);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const uint32_t yv[4] = {pack_bf16(acc[4 * j], acc[4 * j + 1]),
                                  pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
                                  pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
                                  pack_bf16(acc[4 * j + 6], acc[4 * j + 7])};
          stmatrix_t4(ep_s + (8 * (j + (q >> 1)) + r8) * kEpRow + (2 * wl + (q & 1)) * 16, yv);
        }
      }
      fence_proxy_async();  // the staged rows before the bulk copies read them
      consumer_sync(cw);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = wt + 128 * i;
        if (t < rows) {
          if (SWIGLU)
            bulk_store(out + (size_t)(first + t) * (OUT / 2) + ct * (kBM / 2) + cw * 32,
                       ep_s + t * kEpRow, 64);
          else
            bulk_store(out + (size_t)__ldg(rowmap + first + t) * OUT + ct * kBM + cw * 64,
                       ep_s + t * kEpRow, 128);
        }
      }
      bulk_commit();
    }
    bulk_wait();
  }
}

// out[n, 8 c..] = bf16(sum_k w[n, k] * y[n, k, 8 c..]) in k order, each
// product and sum rounded in f32 (no FMA). Bound by bytes: y read once.
__global__ void __launch_bounds__(kCombineThreads)
moe_combine_kernel(const __nv_bfloat16* __restrict__ y, const float* __restrict__ wts,
                   __nv_bfloat16* __restrict__ out, int N, int K, int D) {
  const int chunks = D / 8;
  const size_t total = (size_t)N * chunks;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(i / chunks), c = (int)(i - (size_t)n * chunks);
    float acc[8];
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(wts + (size_t)n * K + k);
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(y + ((size_t)n * K + k) * D) + c);
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float lo = __uint_as_float(u[q] << 16), hi = __uint_as_float(u[q] & 0xFFFF0000u);
        const float plo = __fmul_rn(w, lo), phi = __fmul_rn(w, hi);
        acc[2 * q] = k == 0 ? plo : __fadd_rn(acc[2 * q], plo);
        acc[2 * q + 1] = k == 0 ? phi : __fadd_rn(acc[2 * q + 1], phi);
      }
    }
    uint4 o;
    o.x = pack_bf16(acc[0], acc[1]);
    o.y = pack_bf16(acc[2], acc[3]);
    o.z = pack_bf16(acc[4], acc[5]);
    o.w = pack_bf16(acc[6], acc[7]);
    reinterpret_cast<uint4*>(out + (size_t)n * D)[c] = o;
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

template <bool SWIGLU>
int launch_gemm(const CUtensorMap& tw, const CUtensorMap& tx, const void* x, const void* rowmap,
                const void* tiles, const void* sz, void* out, int n_items, int IN, int OUT, int gs,
                int ctas, cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(moe_gemm_kernel<SWIGLU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<SWIGLU>::kSmem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  moe_gemm_kernel<SWIGLU><<<ctas, kThreads, Layout<SWIGLU>::kSmem, st>>>(
      tw, tx, (const __nv_bfloat16*)x, (const int*)rowmap, (const int*)tiles, (const uint32_t*)sz,
      (__nv_bfloat16*)out, n_items, IN, OUT, gs);
  return (int)cudaGetLastError();
}

// A 2D tensor map over [outer, inner] elements of `esize` bytes (rows
// contiguous), of type `type`.
int encode_2d(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
              uint32_t box_inner, uint32_t box_outer, CUtensorMapSwizzle swizzle,
              CUtensorMapDataType type, int esize) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * esize};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

}  // namespace

// One grouped launch over the schedule `tiles` (int32 [slots, 3]: expert,
// first sorted row, rows; rows 0 from the first unused slot on).
//   swiglu = 1: x bf16 [x_rows, IN] token rows, gathered by rowmap int32
//     [rows] (the token of each sorted row); w uint8 [E, OUT, IN/2] / sz
//     [E, OUT, IN/gs] the interleaved gate and up; out h bf16 [rows, OUT / 2].
//   swiglu = 0: x bf16 [x_rows, IN] the sorted h rows, read by TMA; rowmap
//     int32 [rows] the pair of each sorted row; out y bf16 [pairs, OUT]
//     (each pair's row).
// IN a multiple of 64, gs a multiple of 64 dividing IN, OUT of 128; ctas
// persistent CTAs walk slots x OUT / 128 items.
extern "C" int moe_gemm(const void* x, const void* rowmap, const void* tiles, int slots,
                        const void* w, const void* sz, void* out, int x_rows, int E, int IN,
                        int OUT, int gs, int swiglu, int ctas, void* stream) {
  if (E < 1 || slots < 1 || x_rows < 1 || IN < kBK || IN % kBK || gs % kBK || IN % gs ||
      OUT < kBM || OUT % kBM || ctas < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tw, tx = {};
  int e = encode_2d(&tw, w, IN / 2, (uint64_t)E * OUT, kBK / 2, kBM, CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_DATA_TYPE_UINT8, 1);
  if (e) return e;
  if (!swiglu) {  // the sorted h rows, a tile at a time
    e = encode_2d(&tx, x, IN, x_rows, kBK, kBN, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2);
    if (e) return e;
  }
  const int n_items = slots * (OUT / kBM);
  const cudaStream_t st = (cudaStream_t)stream;
  return swiglu ? launch_gemm<true>(tw, tx, x, rowmap, tiles, sz, out, n_items, IN, OUT, gs, ctas,
                                    st)
                : launch_gemm<false>(tw, tx, x, rowmap, tiles, sz, out, n_items, IN, OUT, gs,
                                     ctas, st);
}

// y bf16 [N, K, D], wts f32 [N, K] -> out bf16 [N, D]; D a multiple of 8.
extern "C" int moe_combine(const void* y, const void* wts, void* out, int N, int K, int D,
                           int ctas, void* stream) {
  if (N < 1 || K < 1 || D < 8 || D % 8 || ctas < 1) return (int)cudaErrorInvalidValue;
  moe_combine_kernel<<<ctas, kCombineThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, (const float*)wts, (__nv_bfloat16*)out, N, K, D);
  return (int)cudaGetLastError();
}
