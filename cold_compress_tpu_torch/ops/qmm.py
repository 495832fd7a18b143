"""Decode matmuls over quantized weights: W4A8 (kernels K1/K2) and W8A8
(kernel K9), wrappers, plain versions and layouts.

Counterpart of ``cold_compress_tpu/ops/pallas_qmm.py``. The CUDA kernel
(``csrc/w4a8_gemv.cu``) replaces ``qmm_w4a8_cpt`` (pallas_qmm.py:712, the
layer projections) and the tiled branch of ``qmm_w4a8_cp_stacked``
(pallas_qmm.py:407, the int4 vocab head): both compute the same W4A8
function, and one kernel serves both.

Function: x is quantized per row to int8 (``sx = max(absmax, 1e-8) * (1/127)``,
round half to even, clip to +-127); per group g, ``d_g = sum xq * (q - 8)``
and ``xs_g = sum xq`` are exact integers; ``y = sx * sum_g (s_g * d_g +
z_g * xs_g)`` in f32. This is W4A8, as on the TPU, not W4A16.

Bound on the H100: bytes (the weight stream at batch 1). The layout is the
port's own ("gemv", see the kernel source): each output column's nibbles
contiguous, repacked once from the checkpoint's rowpack. The kernel's CTAs
walk tiles of output columns over all of IN; ``gemv_partition`` chooses the
tile width for each shape. That repack also ports K10, the TPU's older
layouts of the same function: ``qmm_w4a8`` and
``qmm_w4a8_stacked`` (pallas_qmm.py:294, :215; rowpack, which the JAX
package's unstacked path runs, e.g. under per-layer cache budgets), the
flat branch of ``qmm_w4a8_cp_stacked`` (:407) and ``qmm_w4a8_cpt_split``
(:890). They differ from K1 only in f32 summation order and in how the zero
term is kept; ``w4a8_rowpack_plain`` is the rowpack function computed from
the checkpoint's bytes as they are. The prefill paths
(``dequantize_gemv`` for bf16 ``torch.matmul``, or K8) read the same stored
bytes, so the weights are held once.

K8 (``csrc/w4a8_gemm.cu``, ``w4a8_gemm``) replaces ``qmm_w4a8_prefill``
(pallas_qmm.py:1177) and ``qmm_w4a8_prefill_cpt`` (:1100): the same W4A8
function at prefill size on the int8 tensor cores, opt-in as in the JAX
package (``QuantizedLinear(prefill_w4a8=True)``). Bound: operations at L =
8192.

K9 (``csrc/w8a8_gemv.cu``) replaces ``qmm_w8a8_tiled`` (pallas_qmm.py:1293),
the ``--head_bits 8`` vocab head: int8 weights with one f32 scale per
output column, the activations quantized as above, an exact int32 dot
``d`` and ``y = (d * s_col) * sx`` in f32, in that order. Its layout is the
checkpoint's ``[IN, OUT]`` transposed once to ``[OUT, IN]`` rows. Bound:
bytes (IN*OUT weight bytes at batch 1).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

#: Launch counts of the CUDA kernels, by kernel and caller: the four layer
#: projections and the vocab head. Incremented only where a kernel launches.
LAUNCHES = {
    "w4a8_gemv.wqkv": 0, "w4a8_gemv.wo": 0, "w4a8_gemv.w13": 0,
    "w4a8_gemv.w2": 0, "w4a8_gemv.head": 0,
    "w8a8_gemv.wqkv": 0, "w8a8_gemv.wo": 0, "w8a8_gemv.w13": 0,
    "w8a8_gemv.w2": 0, "w8a8_gemv.head": 0,
    "w4a8_gemm.wqkv": 0, "w4a8_gemm.wo": 0, "w4a8_gemm.w13": 0, "w4a8_gemm.w2": 0,
}

_MASK = 0x0F

#: The f32 reciprocal of 127 (exactly representable as a Python float).
INV_127 = 0.007874015718698502

#: Output columns and activation rows the plain version takes at a time
#: (bound its memory: the per-group dots are ng * rows * columns f32).
PLAIN_COL_CHUNK = 16384
PLAIN_ROW_CHUNK = 256
#: Inputs per f32 partial dot in the W8A8 plain version: 1024 * 127 * 127 <
#: 2**24, so every partial sum of integer products is exact in f32.
W8A8_EXACT_DEPTH = 1024


#: K1's CTA: activation rows (at most) and the column tiles it takes (16
#: warps of 4, 2 or 1 columns). One CTA fills an SM (its shared memory).
GEMV_ROWS = 4
GEMV_COLS = (64, 32, 16)
#: K9's CTA: the same 16 warps of 4, 2 or 1 columns, up to 8 activation
#: rows (a decode step's few rows stream the int8 weights once).
W8A8_ROWS = 8


def gemv_partition(L: int, OUT: int, sm_count: int) -> int:
    """Columns per tile for K1 at these shapes.

    The kernel's grid holds at most one CTA per SM, each walking its tiles
    of all of IN in turn, so a tile width is judged by how evenly its tiles
    share the card: the busy fraction of the last round of tiles. The widest
    tile within 2% of the best is taken; a width whose tiles leave an SM
    without one is not, unless even the narrowest tiles do. IN is not split:
    on the card a split over a cluster lost at every shape of the 8B
    configurations (PERF.md, section 6). Pure Python: the CPU tests check
    it."""
    row_blocks = -(-L // GEMV_ROWS)
    best, best_eff = GEMV_COLS[-1], 0.0
    for cols in GEMV_COLS:
        n = -(-OUT // cols) * row_blocks
        if n < sm_count:
            continue
        rounds = n / sm_count
        eff = rounds / math.ceil(rounds)
        if best_eff == 0.0 or eff > best_eff + 0.02:
            best, best_eff = cols, eff
    return best


#: The share of the SMs K9's tiles must occupy for a tile width to be taken.
W8A8_MIN_FILL = 0.7


def w8a8_partition(L: int, OUT: int, sm_count: int) -> int:
    """Columns per tile for K9 at these shapes: the widest of ``GEMV_COLS``
    whose tiles (times the row blocks of ``W8A8_ROWS``) occupy at least
    ``W8A8_MIN_FILL`` of the SMs, else the narrowest.

    An int8 column is twice an int4 column's bytes, so K9's stream is bound
    by the card's memory rate once about 70% of the SMs pull on it, and each
    further tile a CTA walks adds its fixed costs (the wait for its first
    pieces, the closing reduction): on the card the widest such tile was
    the fastest or within 2% of it at L = 1 (wqkv 64 columns, wo and w2 32;
    PERF.md section 6), where K1's rule (every SM busy) takes 16. Pure
    Python: the CPU tests check it."""
    row_blocks = -(-L // W8A8_ROWS)
    for cols in GEMV_COLS:
        if -(-OUT // cols) * row_blocks >= W8A8_MIN_FILL * sm_count:
            return cols
    return GEMV_COLS[-1]


_SM_COUNT = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    device = torch.device(device)
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SM_COUNT[device]


def rowpack_to_gemv(w: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor):
    """Repack one rowpack int4 weight into the kernel's layout.

    w: int8 [IN/2, OUT]; byte r holds row r (low nibble, unsigned q) and row
    r + IN/2 (high nibble, signed q - 8). scales/zeros: [IN/gs, OUT] bf16.
    Returns (wg uint8 [OUT, IN/2], sz bf16 [OUT, IN/gs, 2]) on w's device.
    """
    q = unpack_rowpack(w)  # [IN, OUT] uint8 0..15
    IN, OUT = q.shape
    if IN % 8:
        raise ValueError(f"int4 weight with {IN} inputs: the layout needs a multiple of 8")
    qt = q.t().reshape(OUT, IN // 8, 2, 4)
    wg = (qt[:, :, 0, :] | (qt[:, :, 1, :] << 4)).reshape(OUT, IN // 2)
    sz = torch.stack([_as_bf16(scales).t(), _as_bf16(zeros).t()], dim=-1)
    return wg.contiguous(), sz.contiguous()


def unpack_rowpack(w: torch.Tensor) -> torch.Tensor:
    """Rowpack bytes [IN/2, OUT] (int8 signed-hi or legacy uint8) -> unsigned
    nibble values [IN, OUT] uint8 in 0..15."""
    if w.dtype == torch.uint8:  # legacy unsigned nibbles: flip the top bit
        w = (w ^ 0x80).view(torch.int8)
    p = w.to(torch.int16)
    lo = p & _MASK
    hi = (p >> 4) + 8  # arithmetic shift recovers the signed q - 8
    return torch.cat([lo, hi], dim=0).to(torch.uint8)


def _as_bf16(a: torch.Tensor) -> torch.Tensor:
    b = a.to(torch.bfloat16)
    if a.dtype != torch.bfloat16 and not torch.equal(b.to(a.dtype), a):
        raise ValueError("int4 scales/zeros must be exactly representable in bf16")
    return b


def unpack_gemv(wg: torch.Tensor) -> torch.Tensor:
    """Kernel-layout bytes [..., OUT, IN/2] -> unsigned nibbles [..., OUT, IN]
    uint8 (leading dimensions: a stack of weights, e.g. a layer's experts)."""
    *lead, IN2 = wg.shape
    b = wg.reshape(*lead, IN2 // 4, 1, 4)
    q = torch.cat([b & _MASK, b >> 4], dim=-2)  # [..., OUT, IN/8, 2, 4]
    return q.reshape(*lead, IN2 * 2)


def dequantize_gemv(wg: torch.Tensor, sz: torch.Tensor, group_size: int,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [..., IN, OUT] weight from the kernel layout [..., OUT, IN/2]:
    ``(q - 8) * s + z`` in f32, cast once to ``dtype``
    (ops/linear.py::dequantize_weight's math). Returned as a transposed
    view of an [..., OUT, IN] tensor."""
    lead = wg.shape[:-1]
    q = unpack_gemv(wg).float().reshape(*lead, -1, group_size)
    s = sz[..., 0].float()[..., None]
    z = sz[..., 1].float()[..., None]
    return ((q - 8.0) * s + z).reshape(*lead, -1).to(dtype).transpose(-1, -2)


def quantize_activations(x: torch.Tensor):
    """Per-row int8 activation quantization (pallas_qmm.py::_quantize_rows):
    returns (xq as f32 integers in [-127, 127], sx [L, 1] f32)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # XLA folds ``/ 127.0`` into a multiplication by the f32 reciprocal,
    # which differs from a true division in the last bit for some rows.
    sx = absmax.clamp_min(1e-8) * INV_127
    xq = torch.round(xf / sx).clamp(-127, 127)  # round half to even
    return xq, sx


def w4a8_gemv_plain(x: torch.Tensor, wg: torch.Tensor, sz: torch.Tensor,
                    group_size: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x [L, IN] -> y [L, OUT] f32.

    The per-group integer dots run as f32 matmuls: every operand is a small
    integer (|xq| <= 127, |q - 8| <= 8) and every partial sum stays below
    2**24, so they are exact in f32 (and in TF32). Rows are independent, so
    a large L is taken ``PLAIN_ROW_CHUNK`` rows at a time, with the same
    result."""
    L, IN = x.shape
    if L > PLAIN_ROW_CHUNK:
        return torch.cat([w4a8_gemv_plain(x[i:i + PLAIN_ROW_CHUNK], wg, sz, group_size)
                          for i in range(0, L, PLAIN_ROW_CHUNK)])
    OUT = wg.shape[0]
    gs = group_size
    ng = IN // gs
    xq, sx = quantize_activations(x)
    xg = xq.reshape(L, ng, gs).transpose(0, 1)  # [ng, L, gs]
    xs = xq.reshape(L, ng, gs).sum(-1)  # [L, ng] exact
    out = []
    for j0 in range(0, OUT, PLAIN_COL_CHUNK):
        j1 = min(OUT, j0 + PLAIN_COL_CHUNK)
        q = unpack_gemv(wg[j0:j1]).float() - 8.0  # [n, IN]
        qg = q.reshape(j1 - j0, ng, gs).permute(1, 2, 0)  # [ng, gs, n]
        d = torch.bmm(xg, qg)  # [ng, L, n] exact integers
        s = sz[j0:j1, :, 0].float().t()[:, None, :]  # [ng, 1, n]
        z = sz[j0:j1, :, 1].float().t()[:, None, :]
        terms = d * s + xs.t()[:, :, None] * z
        out.append(terms.sum(0))
    return torch.cat(out, dim=-1) * sx


def w4a8_rowpack_plain(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
                       zeros: torch.Tensor, group_size: int) -> torch.Tensor:
    """Plain version of K10's rowpack function (``qmm_w4a8``,
    pallas_qmm.py:294) on the checkpoint's bytes, unrepacked: x [L, IN] ->
    y [L, OUT] f32. w int8 [IN/2, OUT] rowpack, scales/zeros [IN/gs, OUT].

    As the TPU kernel keeps them: the low rows' groups (unsigned nibbles)
    take ``s * sum(xq * q) + (z - 8 s) * xs`` with ``z - 8 s`` in f32, the
    high rows' groups (signed q - 8) ``s * sum(xq * (q - 8)) + z * xs``;
    the per-group dots are exact integers, and the sum is scaled by sx.
    Each group lies in one half ((IN/2) % gs == 0, as the TPU gate asks)."""
    L, IN = x.shape
    gs = group_size
    if (IN // 2) % gs:
        raise ValueError(f"rowpack halves of {IN // 2} rows split groups of {gs}")
    ng = IN // gs
    xq, sx = quantize_activations(x)
    xg = xq.reshape(L, ng, gs).transpose(0, 1)  # [ng, L, gs]
    xs = xq.reshape(L, ng, gs).sum(-1).t()[:, :, None]  # [ng, L, 1] exact
    hi = torch.arange(ng, device=x.device) >= ng // 2  # groups of rows IN/2..IN-1
    out = []
    for j0 in range(0, w.shape[1], PLAIN_COL_CHUNK):
        j1 = min(w.shape[1], j0 + PLAIN_COL_CHUNK)
        q = unpack_rowpack(w[:, j0:j1]).float() - 8.0 * hi.repeat_interleave(gs)[:, None]
        d = torch.bmm(xg, q.reshape(ng, gs, j1 - j0))  # [ng, L, n] exact integers
        s = scales[:, j0:j1].float()[:, None, :]
        z = zeros[:, j0:j1].float()[:, None, :]
        zterm = torch.where(hi[:, None, None], z, z - 8.0 * s)
        out.append((d * s + xs * zterm).sum(0))
    return torch.cat(out, dim=-1) * sx


def _lib():
    lib = _build.library("w4a8_gemv")
    fn = lib.w4a8_gemv
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def w4a8_gemv(x: torch.Tensor, wg: torch.Tensor, sz: torch.Tensor,
              group_size: int, counter: str, *, cols: Optional[int] = None) -> torch.Tensor:
    """x [L, IN] @ int4 weight in the kernel layout -> [L, OUT] f32.

    ``counter`` is the key of ``LAUNCHES`` that a launch increments.
    ``cols`` (16, 32 or 64) fixes the kernel's column tile; by default
    ``gemv_partition`` chooses it.

    CPU tensors take the plain version. CUDA tensors launch the kernel; any
    input it does not take raises."""
    if x.device.type == "cpu":
        return w4a8_gemv_plain(x, wg, sz, group_size)
    L, IN = x.shape
    OUT = wg.shape[0]
    gs = group_size
    if x.dtype != torch.bfloat16:
        raise ValueError(f"w4a8_gemv takes bf16 activations, got {x.dtype}")
    if wg.dtype != torch.uint8 or wg.shape != (OUT, IN // 2):
        raise ValueError(f"bad weight {tuple(wg.shape)} {wg.dtype} for IN={IN}")
    if sz.dtype != torch.bfloat16 or sz.shape != (OUT, IN // gs, 2):
        raise ValueError(f"bad scales {tuple(sz.shape)} {sz.dtype}")
    if IN % 32 or IN % gs or gs % 32 or gs > 1024 or (gs // 32) & (gs // 32 - 1):
        raise ValueError(f"unsupported IN={IN} / group size {gs}")
    if not (x.is_contiguous() and wg.is_contiguous() and sz.is_contiguous()):
        raise ValueError("w4a8_gemv needs contiguous inputs")
    if wg.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("weight bytes and activations must be 16-byte aligned")
    if not (x.device == wg.device == sz.device):
        raise ValueError("inputs on different devices")
    if cols is None:
        cols = gemv_partition(L, OUT, sm_count(x.device))
    if cols not in GEMV_COLS:
        raise ValueError(f"w4a8_gemv: cols {cols} not one of {GEMV_COLS}")
    y = torch.empty((L, OUT), dtype=torch.float32, device=x.device)
    status = _lib()(
        x.data_ptr(), wg.data_ptr(), sz.data_ptr(), y.data_ptr(),
        L, IN, OUT, gs, cols, _build.stream_ptr(x.device),
    )
    _build.check(status, "w4a8_gemv")
    LAUNCHES[counter] += 1
    return y


# --------------------------------------------------------------------------
# W4A8 at prefill size (K8)
# --------------------------------------------------------------------------


#: K8's output tile: weight columns (two consumer warpgroups of 64) by
#: activation rows (the wgmma's N).
GEMM_TILE_OUT = 128
GEMM_TILE_ROWS = 128


def gemm_schedule(L: int, OUT: int, sm_count: int):
    """(CTAs, group width) of K8's persistent grid at these shapes.

    At most one CTA per SM, each walking tiles ``blockIdx.x``, ``+ CTAs``, ...
    in the order of ``gemm_tile``: groups of ``group`` weight-column tiles,
    the activation-row tiles in order within a group. The tiles in flight at
    once then span about ``group`` column tiles by ``CTAs / group`` row
    tiles, whose bytes (IN/2 per weight column, IN per activation row, 128
    of each per tile) are least near ``group = sqrt(2 CTAs)``: 16 on 132
    SMs. Pure Python: the CPU tests check it."""
    n_out = -(-OUT // GEMM_TILE_OUT)
    tiles = n_out * -(-L // GEMM_TILE_ROWS)
    ctas = min(tiles, sm_count)
    group = max(1, min(n_out, round(math.sqrt(2 * ctas))))
    return ctas, group


def gemm_tile(t: int, L: int, OUT: int, group: int):
    """Tile ``t`` of K8's schedule -> (weight-column tile, activation-row
    tile); ``csrc/w4a8_gemm.cu::tile_coords`` computes the same."""
    n_out = -(-OUT // GEMM_TILE_OUT)
    n_rows = -(-L // GEMM_TILE_ROWS)
    per = group * n_rows
    g, i = divmod(t, per)
    width = min(group, n_out - g * group)
    return g * group + i % width, i // width


def _lib_gemm():
    lib = _build.library("w4a8_gemm")
    fn, quant = lib.w4a8_gemm, lib.w4a8_gemm_quant
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        quant.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        quant.restype = ctypes.c_int
    return fn, quant


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def gemm_zero_term_on_tensor_cores(IN: int, group_size: int) -> bool:
    """Whether K8 takes its instance with the zero term on the tensor cores
    (group size 128 with IN a multiple of 1024: whole blocks of eight
    groups), which reads the group sums' bf16 halves."""
    return group_size == 128 and IN % 1024 == 0


def w4a8_gemm_quantize(x: torch.Tensor, group_size: int):
    """K8's first launch alone (CUDA tensors): x [L, IN] bf16 -> (xq int8
    [L, IN], sx f32 [L], xs, xsb): the per-row int8 activations, their
    scales and their group sums, where ``gemm_zero_term_on_tensor_cores``
    as xsb int32 [L, IN/gs] (each sum's bf16 halves ``(sum >> 7, sum &
    127)`` packed in one word; xs None), else as xs f32 [IN/gs, Lp],
    transposed and padded to whole tiles of rows (the columns past L are
    not written; xsb None)."""
    L, IN = x.shape
    Lp = -(-L // GEMM_TILE_ROWS) * GEMM_TILE_ROWS
    dev = x.device
    xq = torch.empty((L, IN), dtype=torch.int8, device=dev)
    sx = torch.empty((L,), dtype=torch.float32, device=dev)
    xs = xsb = None
    if gemm_zero_term_on_tensor_cores(IN, group_size):
        xsb = torch.empty((L, IN // group_size), dtype=torch.int32, device=dev)
    else:
        xs = torch.empty((IN // group_size, Lp), dtype=torch.float32, device=dev)
    status = _lib_gemm()[1](x.data_ptr(), xq.data_ptr(), sx.data_ptr(), _ptr(xs), _ptr(xsb),
                            L, IN, group_size, Lp, _build.stream_ptr(dev))
    _build.check(status, "w4a8_gemm_quant")
    return xq, sx, xs, xsb


def w4a8_gemm(x: torch.Tensor, wg: torch.Tensor, sz: torch.Tensor, group_size: int,
              counter: str) -> torch.Tensor:
    """x [L, IN] @ int4 weight in the kernel layout -> [L, OUT] f32, for
    prefill-sized L: K1's function (its plain version is ``w4a8_gemv_plain``)
    on the int8 tensor cores, reading the same stored bytes.

    ``counter`` is the key of ``LAUNCHES`` that a call increments (once: the
    activation quantization and the matmul are its two launches).

    CPU tensors take the plain version. CUDA tensors launch the kernel; any
    input it does not take raises."""
    if x.device.type == "cpu":
        return w4a8_gemv_plain(x, wg, sz, group_size)
    L, IN = x.shape
    OUT = wg.shape[0]
    gs = group_size
    if x.dtype != torch.bfloat16:
        raise ValueError(f"w4a8_gemm takes bf16 activations, got {x.dtype}")
    if wg.dtype != torch.uint8 or wg.shape != (OUT, IN // 2):
        raise ValueError(f"bad weight {tuple(wg.shape)} {wg.dtype} for IN={IN}")
    if sz.dtype != torch.bfloat16 or sz.shape != (OUT, IN // gs, 2):
        raise ValueError(f"bad scales {tuple(sz.shape)} {sz.dtype}")
    # IN a multiple of the kernel's 128-input step; a group size that is a
    # multiple of 32 and divides 128 or is a multiple of it.
    if IN % 128 or IN % gs or gs % 32 or (128 % gs and gs % 128):
        raise ValueError(f"unsupported IN={IN} / group size {gs}")
    if not (x.is_contiguous() and wg.is_contiguous() and sz.is_contiguous()):
        raise ValueError("w4a8_gemm needs contiguous inputs")
    if wg.data_ptr() % 16:
        raise ValueError("weight bytes must be 16-byte aligned")
    if not (x.device == wg.device == sz.device):
        raise ValueError("inputs on different devices")
    dev = x.device
    xq, sx, xs, xsb = w4a8_gemm_quantize(x, gs)
    y = torch.empty((L, OUT), dtype=torch.float32, device=dev)
    ctas, group = gemm_schedule(L, OUT, sm_count(dev))
    Lp = -(-L // GEMM_TILE_ROWS) * GEMM_TILE_ROWS
    status = _lib_gemm()[0](
        xq.data_ptr(), sx.data_ptr(), _ptr(xs), _ptr(xsb), wg.data_ptr(), sz.data_ptr(),
        y.data_ptr(), L, IN, OUT, gs, Lp, ctas, group, _build.stream_ptr(dev),
    )
    _build.check(status, "w4a8_gemm")
    LAUNCHES[counter] += 1
    return y


# --------------------------------------------------------------------------
# W8A8 (K9)
# --------------------------------------------------------------------------


def int8_to_gemv(w: torch.Tensor, scales: torch.Tensor):
    """Repack one int8 weight [IN, OUT] with scales [OUT] into the kernel's
    layout: (wt int8 [OUT, IN], s f32 [OUT]) on w's device."""
    if w.dtype != torch.int8 or w.dim() != 2 or scales.shape != (w.shape[1],):
        raise ValueError(f"bad int8 weight {tuple(w.shape)} {w.dtype} / scales "
                         f"{tuple(scales.shape)}")
    return w.t().contiguous(), scales.float().contiguous()


def dequantize_int8(wt: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [IN, OUT] from the kernel layout: ``w * s`` in f32, cast once to
    ``dtype`` (ops/linear.py::dequantize_weight's int8 math), returned as a
    transposed view of an [OUT, IN] tensor."""
    return (wt.float() * s[:, None]).to(dtype).t()


def w8a8_gemv_plain(x: torch.Tensor, wt: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9: x [L, IN] -> y [L, OUT] f32.

    The integer dot runs as f32 matmuls over ``W8A8_EXACT_DEPTH`` inputs at
    a time (exact, see there) summed in f64, so ``d`` is the exact integer;
    ``float(d)`` rounds to nearest as the kernel's conversion does."""
    OUT, IN = wt.shape
    xq, sx = quantize_activations(x)
    out = []
    for j0 in range(0, OUT, PLAIN_COL_CHUNK):
        j1 = min(OUT, j0 + PLAIN_COL_CHUNK)
        wf = wt[j0:j1].float()
        d = None
        for i0 in range(0, IN, W8A8_EXACT_DEPTH):
            i1 = min(IN, i0 + W8A8_EXACT_DEPTH)
            part = torch.matmul(xq[:, i0:i1], wf[:, i0:i1].t()).double()
            d = part if d is None else d + part
        out.append((d.float() * s[j0:j1]) * sx)
    return torch.cat(out, dim=-1)


def _lib8():
    fn = _build.library("w8a8_gemv").w8a8_gemv
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def w8a8_gemv(x: torch.Tensor, wt: torch.Tensor, s: torch.Tensor, counter: str, *,
              cols: Optional[int] = None) -> torch.Tensor:
    """x [L, IN] @ int8 weight in the kernel layout -> [L, OUT] f32.

    ``counter`` is the key of ``LAUNCHES`` that a launch increments.
    ``cols`` (16, 32 or 64) fixes the kernel's column tile; by default
    ``w8a8_partition`` chooses it.

    CPU tensors take the plain version. CUDA tensors launch the kernel; any
    input it does not take raises."""
    if x.device.type == "cpu":
        return w8a8_gemv_plain(x, wt, s)
    L, IN = x.shape
    OUT = wt.shape[0]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"w8a8_gemv takes bf16 activations, got {x.dtype}")
    if wt.dtype != torch.int8 or wt.shape != (OUT, IN) or IN % 16:
        raise ValueError(f"bad weight {tuple(wt.shape)} {wt.dtype} for IN={IN}")
    if s.dtype != torch.float32 or s.shape != (OUT,):
        raise ValueError(f"bad scales {tuple(s.shape)} {s.dtype}")
    if not (x.is_contiguous() and wt.is_contiguous() and s.is_contiguous()):
        raise ValueError("w8a8_gemv needs contiguous inputs")
    if wt.data_ptr() % 16:
        raise ValueError("weight bytes must be 16-byte aligned")
    if not (x.device == wt.device == s.device):
        raise ValueError("inputs on different devices")
    if cols is None:
        cols = w8a8_partition(L, OUT, sm_count(x.device))
    if cols not in GEMV_COLS:
        raise ValueError(f"w8a8_gemv: cols {cols} not one of {GEMV_COLS}")
    y = torch.empty((L, OUT), dtype=torch.float32, device=x.device)
    status = _lib8()(
        x.data_ptr(), wt.data_ptr(), s.data_ptr(), y.data_ptr(), L, IN, OUT, cols,
        _build.stream_ptr(x.device),
    )
    _build.check(status, "w8a8_gemv")
    LAUNCHES[counter] += 1
    return y
