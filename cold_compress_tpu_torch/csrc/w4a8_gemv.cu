// W4A8 decode matmul: y[L, OUT] = x[L, IN] @ W for int4 group-wise weights.
//
// Replaces the TPU kernels cold_compress_tpu/ops/pallas_qmm.py::qmm_w4a8_cpt
// (layer projections) and the tiled branch of qmm_w4a8_cp_stacked (vocab
// head): the same function on the port's own byte layout.
//
//   x is quantized per row to int8: sx = max(absmax, 1e-8) * f32(1/127),
//   xq = clip(rint(x / sx), -127, 127) (round half to even, true division;
//   act_quant.cuh's formula, bit-identical to pallas_qmm.py::_quantize_rows).
//   Per group g of gs inputs: d_g = sum xq * (q - 8) and xs_g = sum xq, both
//   exact in int32; y = sx * sum_g (s_g * d_g + z_g * xs_g) in f32.
//
// Layout ("gemv", repacked once from the checkpoint's rowpack at load):
//   w  uint8 [OUT, IN/2]: column j's inputs are contiguous. Within each
//      4-byte word covering inputs 8k..8k+7, byte b holds q[8k+b] in its low
//      nibble and q[8k+4+b] in its high nibble (q unsigned, 0..15), so
//      (word & 0x0F0F0F0F) and ((word >> 4) & 0x0F0F0F0F) are four int8
//      lanes each that dp4a multiplies with four int8 activations.
//   sz uint32 [OUT, IN/gs]: bf16 scale (low half) and bf16 zero (high half).
//
// Bound on this card: bytes. At L = 1 the kernel reads IN*OUT/2 weight bytes
// and does 2*IN*OUT integer operations, far below the int8 rate. The design
// keeps every SM's share of the weight stream in flight from the first
// instruction to the last, and spends few instructions per byte:
//   * A CTA owns tiles of `cols` output columns (16 warps of CPW columns)
//     over all of IN. The grid holds at most the CTAs that fit on the card
//     at once, each walking tiles blockIdx.x, + gridDim.x, ...: the
//     activation prologue runs once per CTA, not once per tile.
//     ops/qmm.py::gemv_partition chooses cols.
//   * Each warp streams its columns in pieces of 4096 inputs (2 KB, one TMA
//     bulk copy completing on an mbarrier) through its own ring of kDepth + 1
//     shared-memory slots, kDepth pieces (96 KB per CTA, one CTA per SM) in
//     flight across tile boundaries; the copies leave the load/store pipe to
//     the activation prologue. Its lanes read a piece back a group at a time
//     (in a rotated order that keeps the reads conflict-free), so a lane
//     holds 128 whole inputs and its group dots (gs <= 128) need no
//     shuffle. No CTA-wide barrier follows the prologue.
//   * x goes first: its loads are issued before the first kDepth weight
//     pieces (which do not depend on it), so they do not queue behind them;
//     the prologue (the row's absmax, then int8 quantization with exact
//     group sums) then overlaps the weight stream. It is the kernel's longest
//     serial part, so a CTA is 16 warps wide (one per SM), and the division
//     is made exact from a reciprocal.
//   * Every sum has a fixed order: two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "w4a8_dot.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;            // activation rows per CTA, at most
constexpr int kPiece = 4096;        // inputs of one column a warp streams at a time
constexpr int kLaneIn = kPiece / 32;  // 128 inputs (64 bytes) per lane
constexpr int kDepth = 3;           // pieces in flight per warp
constexpr int kSlots = kDepth + 1;
constexpr int kMaxCols = kWarps * 4;
constexpr int kXRegs = 8;           // 16-byte chunks of x a thread holds (IN <= 32768 at L = 1)
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Bytes that a bulk copy will land on `bar`, with this thread's arrival.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
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

// One 1D bulk copy (TMA) of `bytes` (a multiple of 16) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Position of input i among the CTA's int8 activations: for
// each piece, lane L's 16-byte run j (inputs L*128 + 16j .. +15) at
// (j * 32 + L) * 16, so that a warp reads 512 consecutive bytes.
__device__ __forceinline__ int xq_pos(int i) {
  const int o = i & (kPiece - 1);
  return (i - o) + (((o >> 4) & 7) * 32 + (o >> 7)) * 16 + (o & 15);
}

#ifdef GEMV_PHASES
// Built so by scripts/torch_gemv_phases.py: thread 0 of each CTA stamps
// %globaltimer at the end of each of the kernel's phases (GEMV_STAMP(k)).
constexpr unsigned kStampedCtas = 65536;
__device__ unsigned long long g_stamps[kStampedCtas * 8];
#define GEMV_STAMP(k)                                                        \
  do {                                                                       \
    const unsigned b_ = blockIdx.x + gridDim.x * blockIdx.y;                 \
    if (threadIdx.x == 0 && b_ < kStampedCtas) {                             \
      unsigned long long t_;                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                 \
      g_stamps[b_ * 8 + (k)] = t_;                                           \
    }                                                                        \
  } while (0)
#else
#define GEMV_STAMP(k) \
  do {            \
  } while (0)
#endif

// Bytes of one ring slot: a piece's weights, then each lane's scale/zero
// words (one per group it touches: 128 / gs of them below 128 inputs).
__host__ __device__ __forceinline__ int slot_bytes(int gs) {
  return kPiece / 2 + 32 * 4 * (gs < kLaneIn ? kLaneIn / gs : 1);
}

template <int CPW, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
w4a8_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                 const uint32_t* __restrict__ sz, float* __restrict__ y, int L, int IN,
                 int OUT, int gs, int tiles, int rpc) {
  constexpr int kCols = kWarps * CPW;
  __shared__ float red[kWarps][ROWS];
  __shared__ __align__(8) uint64_t wbar[kWarps][kSlots];  // each warp's ring slots
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ng = IN / gs, IN2 = IN / 2;
  const int npc = (IN + kPiece - 1) / kPiece;  // pieces per column
  const int kpad = npc * kPiece;
  const int l0 = blockIdx.y * rpc;  // rows [l0, l0 + nrows), rpc <= ROWS
  const int nrows = min(rpc, L - l0);
  const int sb = slot_bytes(gs), gpl = gs < kLaneIn ? kLaneIn / gs : 1;
  const int gshift = __ffs(gs) - 1;  // gs is a power of two
  const int ring_bytes = kWarps * kSlots * sb;

  unsigned char* ring = smem + warp * kSlots * sb;
  int8_t* xq = reinterpret_cast<int8_t*>(smem + ring_bytes);                     // [rows][kpad]
  int* xs = reinterpret_cast<int*>(smem + ring_bytes + min(L, rpc) * kpad);      // [rows][ng]
  const uint32_t ring_s = smem_u32(ring);

  // ---- 1. x's loads first (one row: held in registers), then kDepth pieces ----
  const int cpr = (IN + kThreads * 8 - 1) / (kThreads * 8);  // 16-byte chunks per thread per row
  const bool xregs = (ROWS == 1 || nrows == 1) && cpr <= kXRegs;
  uint4 xv[kXRegs];
  if (xregs) {
    const __nv_bfloat16* xr = x + (size_t)l0 * IN;
#pragma unroll
    for (int m = 0; m < kXRegs; ++m) {
      const int i = tid * 8 + m * kThreads * 8;
      xv[m] = (m < cpr && i < IN) ? __ldg(reinterpret_cast<const uint4*>(xr + i))
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  GEMV_STAMP(0);

  if (lane == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(smem_u32(&wbar[warp][s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // Piece (t, p, j): tile t, column t * kCols + warp * CPW + j, inputs
  // [p * 4096, p * 4096 + 4096), in that order (a lane's activations serve
  // the CPW columns in turn). Its weight bytes come in one bulk copy that
  // lane 0 issues; each lane copies its own groups' scale/zero words.
  int it = blockIdx.x, ij = 0, ip = 0, islot = 0;
  auto issue = [&]() {
    if (it < tiles) {
      const int col = it * kCols + warp * CPW + ij;
      const uint32_t dst = ring_s + islot * sb;
      const uint32_t bytes = col < OUT ? min(kPiece, IN - ip * kPiece) / 2 : 0;
      if (lane == 0) {
        const uint32_t bar = smem_u32(&wbar[warp][islot]);
        mbar_expect(bar, bytes);
        if (bytes) {
          // The slot's last reads (other lanes, generic proxy) come first.
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          bulk_copy(dst, w + (size_t)col * IN2 + ip * kPiece / 2, bytes, bar);
        }
      }
      if (col < OUT) {
        // This lane's groups' scale/zero words (one per group it touches).
        const int off = ip * kPiece + lane * kLaneIn;
        const uint32_t* szp = sz + (size_t)col * ng + (off >> gshift);
        for (int q = 0; q < gpl; ++q)
          if (off + (q << gshift) < IN) cp_async4(dst + kPiece / 2 + (lane * gpl + q) * 4, szp + q);
      }
      if (++ij == CPW) {
        ij = 0;
        if (++ip == npc) {
          ip = 0;
          it += gridDim.x;
        }
      }
    }
    cp_async_commit();  // one group per piece, empty past the end
    islot = islot == kSlots - 1 ? 0 : islot + 1;
  };
#pragma unroll 1
  for (int s = 0; s < kDepth; ++s) issue();

  GEMV_STAMP(1);
  // ---- 2. activations: the absmax of each whole row ----
  for (int i = tid; i < nrows * ng; i += kThreads) xs[i] = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= nrows) break;
    float m = 0.f;
    if (xregs) {
#pragma unroll
      for (int q = 0; q < kXRegs; ++q) m = fmaxf(m, absmax8(xv[q]));
    } else {
      const __nv_bfloat16* xr = x + (size_t)(l0 + r) * IN;
      for (int i = tid * 8; i < IN; i += kThreads * 8)
        m = fmaxf(m, absmax8(__ldg(reinterpret_cast<const uint4*>(xr + i))));
    }
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red[warp][r] = m;
  }
  __syncthreads();
  float sx[ROWS], rsx[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float m = 0.f;
    if (r < nrows)
      for (int i = 0; i < kWarps; ++i) m = fmaxf(m, red[i][r]);
    sx[r] = __fmul_rn(fmaxf(m, 1e-8f), 1.0f / 127.0f);
    rsx[r] = __frcp_rn(sx[r]);
  }

  GEMV_STAMP(2);
  // ---- 3. int8 activations, and exact group sums ----
  // Thread tid's chunks are inputs tid * 8 + m * 2048 of the row, as loaded
  // above: a group's gs / 8 chunks lie in consecutive lanes of one warp (or
  // span whole warps above 256 inputs).
  {
    const int lanes = min(gs / 8, 32);
    auto put = [&](int r, int i, const uint4& v) {
      int sum = 0;
      const bool mine = i < IN;
      if (mine) {
        uint2 q;
        sum = quant8(v, sx[r], rsx[r], &q);
        *reinterpret_cast<uint2*>(xq + r * kpad + xq_pos(i)) = q;
      }
      for (int off = 1; off < lanes; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (mine && (lane & (lanes - 1)) == 0) {
        if (gs <= 256) xs[r * ng + (i >> gshift)] = sum;
        else atomicAdd(&xs[r * ng + (i >> gshift)], sum);  // integers: exact in any order
      }
    };
    if (xregs) {
#pragma unroll
      for (int m = 0; m < kXRegs; ++m)
        if (m < cpr) put(0, tid * 8 + m * kThreads * 8, xv[m]);
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= nrows) break;
        const __nv_bfloat16* xr = x + (size_t)(l0 + r) * IN;
        for (int m = 0; m < cpr; ++m) {
          const int i = tid * 8 + m * kThreads * 8;
          put(r, i, i < IN ? __ldg(reinterpret_cast<const uint4*>(xr + i))
                           : make_uint4(0u, 0u, 0u, 0u));
        }
      }
    }
  }
  __syncthreads();

  GEMV_STAMP(3);
  // ---- 4. the weight stream, tile by tile: consume piece u, issue u + kDepth ----
  const int lpg = max(1, gs / kLaneIn);  // lanes per group (above 128 inputs)
  // A lane reads its four 16-byte chunks (4 * lane + kk) in the order
  // kk = (k + rot) % 4, so that every 8 lanes meet 8 distinct bank groups;
  // its activations are read in the same order.
  const int rot = (lane >> 1) & 3;
  int slot = 0;
  uint32_t phase = 0;  // bit s: the parity slot s's barrier completes next
  int4 xa[4], xb[4];   // this lane's 128 int8 activations of one piece and row
  auto load_x = [&](int r, int p) {
    const int8_t* xr = xq + r * kpad + p * kPiece + lane * 16;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int kk = (k + rot) & 3;
      xa[k] = *reinterpret_cast<const int4*>(xr + (2 * kk) * 512);
      xb[k] = *reinterpret_cast<const int4*>(xr + (2 * kk + 1) * 512);
    }
  };
  // One piece's share of one column at one row: its groups' terms.
  auto term = [&](const uint4 (&wv)[4], uint4 szv, int r, int off, bool col_ok) {
    int d[4] = {0, 0, 0, 0};  // by chunk kk (below 128-input groups), else d[0]
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int kk = (k + rot) & 3;
      const int dk = (col_ok && off + 32 * kk < IN) ? dot32(xa[k], xb[k], wv[k]) : 0;
      if (gs >= kLaneIn) {
        d[0] += dk;
      } else {
        d[0] += kk == 0 ? dk : 0;
        d[1] += kk == 1 ? dk : 0;
        d[2] += kk == 2 ? dk : 0;
        d[3] += kk == 3 ? dk : 0;
      }
    }
    const int* xsr = xs + r * ng + (off >> gshift);
    float v = 0.f;
    if (gs >= kLaneIn) {
      int dd = d[0];
      for (int o = 1; o < lpg; o <<= 1) dd += __shfl_xor_sync(0xffffffffu, dd, o);
      if (col_ok && off < IN && (lane & (lpg - 1)) == 0) v = group_term(dd, xsr[0], szv.x);
    } else if (gs == 64) {
      if (col_ok && off < IN) v = group_term(d[0] + d[1], xsr[0], szv.x);
      if (col_ok && off + 64 < IN) v += group_term(d[2] + d[3], xsr[1], szv.y);
    } else {  // gs == 32
      const uint32_t zs[4] = {szv.x, szv.y, szv.z, szv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (col_ok && off + 32 * k < IN) v += group_term(d[k], xsr[k], zs[k]);
    }
    return v;
  };
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    float acc[CPW][ROWS];
#pragma unroll
    for (int j = 0; j < CPW; ++j)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[j][r] = 0.f;
    const int col0 = t * kCols + warp * CPW;
    for (int p = 0; p < npc; ++p) {
      const int off = p * kPiece + lane * kLaneIn;  // this lane's first input
      if (ROWS == 1 || nrows == 1) load_x(0, p);    // once for the CPW columns
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        cp_async_wait<kDepth - 1>();  // this lane's scale/zero words landed
        mbar_wait(smem_u32(&wbar[warp][slot]), (phase >> slot) & 1);  // and the weights
        phase ^= 1u << slot;
        const unsigned char* sl = ring + slot * sb;
        uint4 wv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wv[k] = *reinterpret_cast<const uint4*>(sl + (lane * 4 + ((k + rot) & 3)) * 16);
        const uint32_t* szl = reinterpret_cast<const uint32_t*>(sl + kPiece / 2) + lane * gpl;
        uint4 szv = make_uint4(szl[0], 0u, 0u, 0u);
        if (gpl > 1) szv.y = szl[1];
        if (gpl > 2) {
          szv.z = szl[2];
          szv.w = szl[3];
        }
        slot = slot == kSlots - 1 ? 0 : slot + 1;
        __syncwarp();  // every lane has read the slot consumed one piece ago
        issue();       // into that slot
        const bool col_ok = col0 + j < OUT;
        if (ROWS == 1 || nrows == 1) {
          acc[j][0] += term(wv, szv, 0, off, col_ok);
        } else {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (r >= nrows) break;  // uniform across the warp
            load_x(r, p);
            acc[j][r] += term(wv, szv, r, off, col_ok);
          }
        }
      }
    }

    GEMV_STAMP(4);  // the last tile's is kept
    // ---- 5. the tile's columns: over the warp's lanes ----
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= nrows) break;
        float v = acc[j][r];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0 && col0 + j < OUT) y[(size_t)(l0 + r) * OUT + col0 + j] = v * sx[r];
      }
    }
  }
  cp_async_wait<0>();
  GEMV_STAMP(5);
}

template <int CPW, int ROWS>
size_t static_smem() {
  static size_t bytes = 0;
  if (bytes == 0) {
    cudaFuncAttributes a;
    if (cudaFuncGetAttributes(&a, w4a8_gemv_kernel<CPW, ROWS>) == cudaSuccess) bytes = a.sharedSizeBytes;
  }
  return bytes;
}

// CTAs of this variant that one SM holds at `dyn` bytes of dynamic shared
// memory, cached per size (a decode step alternates a few sizes). The cache
// replaces its oldest entry, so the sizes that a decode loop's eager first
// step queried are still there when the step is captured right after (a
// CUDA graph): the capture queries nothing.
template <int CPW, int ROWS>
int per_sm(size_t dyn) {
  constexpr int kCache = 32;
  static size_t keys[kCache] = {};
  static int vals[kCache] = {};
  static int next = 0;
  for (int i = 0; i < kCache; ++i)
    if (vals[i] > 0 && keys[i] == dyn) return vals[i];
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, w4a8_gemv_kernel<CPW, ROWS>, kThreads, dyn) !=
      cudaSuccess)
    return 0;
  keys[next] = dyn;
  vals[next] = n;
  next = (next + 1) % kCache;
  return n;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

template <int CPW, int ROWS>
int launch(const void* x, const void* w, const void* sz, void* y, int L, int IN, int OUT,
           int gs, cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    const size_t most = kSmemLimit - static_smem<CPW, ROWS>();
    cudaError_t e = cudaFuncSetAttribute(w4a8_gemv_kernel<CPW, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  constexpr int kCols = kWarps * CPW;
  const int ng = IN / gs;
  const int kpad = ((IN + kPiece - 1) / kPiece) * kPiece;
  // Rows per CTA: 4, or fewer where their activations would not fit.
  const size_t room = kSmemLimit - static_smem<CPW, ROWS>() - (size_t)kWarps * kSlots * slot_bytes(gs);
  int rpc = ROWS;
  while (rpc > 1 && (size_t)min(L, rpc) * (kpad + ng * 4) > room) rpc /= 2;
  const int rows = min(L, rpc);
  if ((size_t)rows * (kpad + ng * 4) > room) return (int)cudaErrorInvalidValue;
  const int row_blocks = (L + rpc - 1) / rpc;
  const size_t dyn = (size_t)kWarps * kSlots * slot_bytes(gs) + (size_t)rows * (kpad + ng * 4);
  const int tiles = (OUT + kCols - 1) / kCols;
  // At most the CTAs the card holds at once, each walking tiles.
  const int fit = per_sm<CPW, ROWS>(dyn) * sm_count() / row_blocks;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  w4a8_gemv_kernel<CPW, ROWS><<<dim3(min(tiles, fit), row_blocks), kThreads, dyn, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)w, (const uint32_t*)sz, (float*)y, L, IN, OUT,
      gs, tiles, rpc);
  return (int)cudaGetLastError();
}

}  // namespace

// cols: output columns per tile (16, 32 or 64); ops/qmm.py::gemv_partition
// chooses it.
extern "C" int w4a8_gemv(const void* x, const void* w, const void* sz, void* y, int L, int IN,
                         int OUT, int gs, int cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (cols) {
    case kWarps:
      return L == 1 ? launch<1, 1>(x, w, sz, y, L, IN, OUT, gs, st)
                    : launch<1, kRows>(x, w, sz, y, L, IN, OUT, gs, st);
    case 2 * kWarps:
      return L == 1 ? launch<2, 1>(x, w, sz, y, L, IN, OUT, gs, st)
                    : launch<2, kRows>(x, w, sz, y, L, IN, OUT, gs, st);
    case kMaxCols:
      return L == 1 ? launch<4, 1>(x, w, sz, y, L, IN, OUT, gs, st)
                    : launch<4, kRows>(x, w, sz, y, L, IN, OUT, gs, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef GEMV_PHASES
extern "C" int w4a8_gemv_stamps(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, (size_t)n * 8 * sizeof(unsigned long long));
}
#endif
