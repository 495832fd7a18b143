// W8A8 decode matmul: y[L, OUT] = x[L, IN] @ W for an int8 weight with one
// f32 scale per output column (the --head_bits 8 vocab head and the
// --weight_bits 8 layer projections).
//
// Replaces the TPU kernel cold_compress_tpu/ops/pallas_qmm.py::
// qmm_w8a8_tiled (tiled int8 head): the same function on the port's layout.
//   x is quantized per row to int8 (act_quant.cuh, bit-identical to
//   _quantize_rows); d = sum xq * w is an exact int32 dot (dp4a);
//   y = (float(d) * s_col) * sx in f32, in that order, as the TPU kernel's
//   epilogue (d * s) and its wrapper (* sx) compute it.
//
// Layout: w int8 [OUT, IN], each output column's inputs contiguous (repacked
// once from the checkpoint's [IN, OUT]); s f32 [OUT]. The ragged edge of
// OUT (128256 columns) is masked, so nothing is padded.
//
// Bound on this card: bytes. At L = 1 the kernel reads IN*OUT weight bytes
// and does 2*IN*OUT integer operations, far below the int8 rate. The design
// is the W4A8 decode kernel's (w4a8_gemv.cu): keep every SM's share of the
// weight stream in flight from the first instruction to the last.
//   * A CTA owns tiles of `cols` output columns (16 warps of CPW columns)
//     over all of IN. The grid holds at most the CTAs that fit on the card
//     at once, each walking tiles blockIdx.x, + gridDim.x, ...: the
//     activation prologue runs once per CTA, not once per tile.
//     ops/qmm.py::gemv_partition chooses cols.
//   * Each warp streams its columns in pieces of 2048 inputs (2 KB, one TMA
//     bulk copy completing on an mbarrier) through its own ring of slots,
//     4 pieces (128 KB per CTA) in flight at one row, 3 at more, across
//     tile boundaries. The first copies are issued before the activation
//     prologue, which they do not depend on. Before them, x itself comes
//     to shared memory by one bulk copy where it fits, so that the prologue
//     (act_quant.cuh's quantize_rows_int8, once per CTA) does not wait for
//     it behind the weight pieces.
//   * A CTA takes up to 8 rows (two instances: one row, and up to 8), so
//     a decode step's few rows stream the weights once.
//   * A lane holds a contiguous run of 64 inputs of a column (four 16-byte
//     chunks, read in a rotated order that keeps the reads conflict-free),
//     so its dot needs no shuffle until the tile ends; then one reduction
//     over the warp sums all of its CPW x rows dots together (each step
//     halves the values a lane carries), not one reduction per (column, row).
//   * The one-row instance is the decode step's: a cold launch fetches less
//     code.
//   * Integer sums are exact in any order, and the epilogue is fixed: the
//     outputs are the plain version's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;              // activation rows per CTA, at most
constexpr int kPiece = 2048;          // inputs (bytes) of one column a warp streams at a time
constexpr int kLaneIn = kPiece / 32;  // 64 inputs per lane
// Pieces in flight per warp: 4 at one row; 3 at more, which leaves room for
// up to 8 rows of activations beside the ring.
template <int ROWS>
__host__ __device__ constexpr int depth() { return ROWS == 1 ? 4 : 3; }
template <int ROWS>
__host__ __device__ constexpr int ring_bytes() { return kWarps * (depth<ROWS>() + 1) * kPiece; }
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

__device__ __forceinline__ int dot16(const int4& x, const int4& w, int d) {
  d = __dp4a(x.x, w.x, d);
  d = __dp4a(x.y, w.y, d);
  d = __dp4a(x.z, w.z, d);
  return __dp4a(x.w, w.w, d);
}

// Sums each of a lane's V values over the warp. Each step with V > 1 keeps
// half of the values (the upper half where the lane's bit `o` is set) and
// adds the partner's copy of the same half, so the warp shuffles V - 1 + the
// remaining steps' values instead of 5 V. Returns the lane's value index,
// or -1 where the lane holds no final sum.
template <int V>
__device__ __forceinline__ int warp_sum_many(int (&v)[V], int lane) {
  int idx = 0, n = V;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (n > 1) {
      const int half = n / 2;
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i < half) {
          const int keep = upper ? v[i + half] : v[i];
          const int send = upper ? v[i] : v[i + half];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      if (upper) idx += half;
      n = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  // After the halving steps (log2 V of them, bits 16, 8, ...), lanes agree on
  // the lower bits: the lane with those bits clear reports.
  constexpr int kLow = 32 / (V > 32 ? 32 : V);
  return (lane & (kLow - 1)) == 0 ? idx : -1;
}

template <int CPW, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s, float* __restrict__ y, int L, int IN, int OUT,
                 int tiles, int rpc, int stage_x) {
  constexpr int kCols = kWarps * CPW;
  constexpr int kDepth = depth<ROWS>(), kSlots = kDepth + 1, kRingBytes = ring_bytes<ROWS>();
  __shared__ float red[kWarps];
  __shared__ float sx[ROWS];
  __shared__ __align__(8) uint64_t wbar[kWarps][depth<ROWS>() + 1];  // each warp's ring slots
  __shared__ __align__(8) uint64_t xbar;  // x's copy, where it is staged
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int npc = (IN + kPiece - 1) / kPiece;  // pieces per column
  const int l0 = blockIdx.y * rpc;             // rows [l0, l0 + nrows), rpc <= ROWS
  const int nrows = min(rpc, L - l0);
  unsigned char* ring = smem + warp * kSlots * kPiece;
  int8_t* xq = reinterpret_cast<int8_t*>(smem + kRingBytes);  // [nrows][IN]
  // Where it fits (stage_x), x itself comes to shared memory first, by one
  // bulk copy issued before any weight piece, so that it does not queue
  // behind them.
  const __nv_bfloat16* xs =
      reinterpret_cast<const __nv_bfloat16*>(smem + kRingBytes + (size_t)nrows * IN);
  const uint32_t ring_s = smem_u32(ring);

  if (stage_x && tid == 0) {
    const uint32_t bar = smem_u32(&xbar);
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(bar, 2 * IN * nrows);
    bulk_copy(smem_u32(xs), x + (size_t)l0 * IN, 2 * IN * nrows, bar);
  }
  if (lane == 0) {
    for (int k = 0; k < kSlots; ++k) mbar_init(smem_u32(&wbar[warp][k]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (stage_x) __syncthreads();  // x's copy is issued; its barrier is set up
  else __syncwarp();

  // Piece (t, p, j): tile t, column t * kCols + warp * CPW + j, inputs
  // [p * 2048, p * 2048 + 2048), in that order (a lane's activations serve
  // the CPW columns in turn), one bulk copy that lane 0 issues.
  int it = blockIdx.x, ij = 0, ip = 0, islot = 0;
  auto issue = [&]() {
    if (it < tiles && lane == 0) {
      const int col = it * kCols + warp * CPW + ij;
      const uint32_t bytes = col < OUT ? min(kPiece, IN - ip * kPiece) : 0;
      const uint32_t bar = smem_u32(&wbar[warp][islot]);
      mbar_expect(bar, bytes);
      if (bytes) {
        // The slot's last reads (other lanes, generic proxy) come first.
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bulk_copy(ring_s + islot * kPiece, w + (size_t)col * IN + ip * kPiece, bytes, bar);
      }
    }
    if (it < tiles) {
      if (++ij == CPW) {
        ij = 0;
        if (++ip == npc) {
          ip = 0;
          it += gridDim.x;
        }
      }
    }
    islot = islot == kSlots - 1 ? 0 : islot + 1;
  };
#pragma unroll 1
  for (int k = 0; k < kDepth; ++k) issue();

  // The activations, once per CTA, while the first pieces land.
  if (stage_x) {
    mbar_wait(smem_u32(&xbar), 0);
    quantize_rows_int8<kWarps>(xs, IN, 0, nrows, xq, sx, red);
  } else {
    quantize_rows_int8<kWarps>(x, IN, l0, nrows, xq, sx, red);
  }

  // A lane reads its four 16-byte chunks (4 * lane + kk) in the order
  // kk = (k + rot) % 4, so that every 8 lanes meet 8 distinct bank groups;
  // its activations are read in the same order.
  const int rot = (lane >> 1) & 3;
  int slot = 0;
  uint32_t phase = 0;  // bit k: the parity slot k's barrier completes next
  int4 xa[4];          // this lane's 64 int8 activations of one piece and row
  auto load_x = [&](int r, int p) {
    const int off = p * kPiece + lane * kLaneIn;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = off + 16 * ((k + rot) & 3);
      xa[k] = i < IN ? *reinterpret_cast<const int4*>(xq + r * IN + i) : make_int4(0, 0, 0, 0);
    }
  };
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int acc[CPW * ROWS];
#pragma unroll
    for (int v = 0; v < CPW * ROWS; ++v) acc[v] = 0;
    const int col0 = t * kCols + warp * CPW;
    for (int p = 0; p < npc; ++p) {
      if (ROWS == 1 || nrows == 1) load_x(0, p);  // once for the CPW columns
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        mbar_wait(smem_u32(&wbar[warp][slot]), (phase >> slot) & 1);
        phase ^= 1u << slot;
        const unsigned char* sl = ring + slot * kPiece;
        int4 wv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wv[k] = *reinterpret_cast<const int4*>(sl + (lane * 4 + ((k + rot) & 3)) * 16);
        slot = slot == kSlots - 1 ? 0 : slot + 1;
        __syncwarp();  // every lane has read the slot consumed one piece ago
        issue();       // into that slot
        // Chunks past IN (last piece) read no activation: xa is 0 there, and
        // a column past OUT is never written.
        if (ROWS == 1 || nrows == 1) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[j * ROWS] = dot16(xa[k], wv[k], acc[j * ROWS]);
        } else {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (r >= nrows) break;  // uniform across the warp
            load_x(r, p);
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[j * ROWS + r] = dot16(xa[k], wv[k], acc[j * ROWS + r]);
          }
        }
      }
    }
    // The tile's CPW x ROWS dots, summed over the warp in one reduction.
    const int v = warp_sum_many<CPW * ROWS>(acc, lane);
    if (v >= 0) {
      const int j = v / ROWS, r = v % ROWS, col = col0 + j;
      if (r < nrows && col < OUT)
        y[(size_t)(l0 + r) * OUT + col] = __fmul_rn(__fmul_rn((float)acc[0], s[col]), sx[r]);
    }
  }
}

template <int CPW, int ROWS>
size_t static_smem() {
  static size_t bytes = 0;
  if (bytes == 0) {
    cudaFuncAttributes a;
    if (cudaFuncGetAttributes(&a, w8a8_gemv_kernel<CPW, ROWS>) == cudaSuccess)
      bytes = a.sharedSizeBytes;
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
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, w8a8_gemv_kernel<CPW, ROWS>, kThreads,
                                                    dyn) != cudaSuccess)
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
int launch(const void* x, const void* w, const void* s, void* y, int L, int IN, int OUT,
           cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    const size_t most = kSmemLimit - static_smem<CPW, ROWS>();
    cudaError_t e = cudaFuncSetAttribute(w8a8_gemv_kernel<CPW, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  constexpr int kCols = kWarps * CPW;
  // Rows per CTA: 4, or fewer where their activations would not fit.
  // At one row the CTA also holds x itself (2 IN bytes).
  // Rows per CTA: all of L up to ROWS, with x copied to shared memory (3 IN
  // bytes a row with its int8 copy) where that fits, else read from global
  // memory (IN bytes a row); fewer rows where neither fits.
  const size_t room = kSmemLimit - static_smem<CPW, ROWS>() - (size_t)ring_bytes<ROWS>();
  int rpc = min(L, ROWS), stage_x = 0;
  for (;;) {
    if ((size_t)rpc * 3 * IN <= room) {
      stage_x = 1;
      break;
    }
    if ((size_t)rpc * IN <= room) break;
    if (rpc == 1) return (int)cudaErrorInvalidValue;
    rpc = rpc > 4 ? 4 : rpc / 2;
  }
  const int row_blocks = (L + rpc - 1) / rpc;
  const size_t dyn = (size_t)ring_bytes<ROWS>() + (size_t)rpc * IN * (stage_x ? 3 : 1);
  const int tiles = (OUT + kCols - 1) / kCols;
  // At most the CTAs the card holds at once, each walking tiles.
  const int fit = per_sm<CPW, ROWS>(dyn) * sm_count() / row_blocks;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  w8a8_gemv_kernel<CPW, ROWS><<<dim3(min(tiles, fit), row_blocks), kThreads, dyn, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)s, (float*)y, L, IN, OUT, tiles,
      rpc, stage_x);
  return (int)cudaGetLastError();
}

}  // namespace

// cols: output columns per tile (16, 32 or 64); ops/qmm.py::gemv_partition
// chooses it.
extern "C" int w8a8_gemv(const void* x, const void* w, const void* s, void* y, int L, int IN,
                         int OUT, int cols, void* stream) {
  if (L < 1 || IN < 16 || IN % 16 || OUT < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cols) {
    case kWarps:
      return L == 1 ? launch<1, 1>(x, w, s, y, L, IN, OUT, st)
                    : launch<1, kRows>(x, w, s, y, L, IN, OUT, st);
    case 2 * kWarps:
      return L == 1 ? launch<2, 1>(x, w, s, y, L, IN, OUT, st)
                    : launch<2, kRows>(x, w, s, y, L, IN, OUT, st);
    case 4 * kWarps:
      return L == 1 ? launch<4, 1>(x, w, s, y, L, IN, OUT, st)
                    : launch<4, kRows>(x, w, s, y, L, IN, OUT, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
