"""A mixture of experts' MLP over int4 experts: the grouped decode GEMV
(``csrc/moe_gemv.cu``), its plain version, and the prefill's experts.

The JAX package has no expert layer; this follows the published layer
equations (``models/transformer.py::moe_forward`` routes). An expert is
SwiGLU over three int4 group-wise weights (gate ``w1``, up ``w3``, down
``w2``), each K1's function at decode (W4A8: the rows quantized to int8
per row) and a bf16 product over the dequantized weights at prefill.

Layout (``MoEWeights.from_experts``, once at build): every expert's leaves
repacked into K1's "gemv" layout (``ops/qmm.py::rowpack_to_gemv``) and
stacked, gate and up interleaved column by column (column 2j gate j, 2j + 1
up j): ``w13`` uint8 [E, 2F, D/2] with ``sz13`` bf16 [E, 2F, D/gs, 2], and
``w2`` [E, D, F/2] with ``sz2`` [E, D, F/gs, 2].

Decode (``moe_decode``): two launches a layer for up to 8 lanes (a larger
batch launches them per group of 8), reading the ids and weights the router
left on the card, so that the step stays one captured graph. The first
(gate and up, SwiGLU in its epilogue) reads each selected expert once
however many of its lanes chose it and adds the number of distinct experts
to a device counter of the layer (``expert_counter``),
which ``ops.kernel_launches`` reports as ``moe_gemv.experts.<layer>``; the
second (down) combines the lanes' K rows in k order. Launch counters
``moe_gemv.w13`` and ``moe_gemv.w2``.

Prefill (``moe_prefill``): every token's K pairs sorted by expert on the
card (``dispatch``: a stable sort, each expert's first row and a schedule of
tiles of at most ``TILE_ROWS`` rows of one expert, sized from N alone, so no
host read), each expert's rows through its weights dequantized to bf16 (bf16
products, f32 sums), SwiGLU, the rows put back in pair order and combined as
at decode. No token is dropped. CUDA tensors take ``csrc/moe_gemm.cu``'s
three launches a layer (counters ``moe_gemm.w13``, ``moe_gemm.w2`` and
``moe_combine``): a grouped GEMM over the schedule that dequantizes the
stored int4 leaves in registers, gathers the token rows by index and writes
SwiGLU's bf16 h; the same over the down weights, each row written to its
pair's place; one pass that combines each token's K rows in k order.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, NamedTuple

import torch

from . import _build, qmm

#: Launch counts of the CUDA kernels (incremented only where they launch).
LAUNCHES = {"moe_gemv.w13": 0, "moe_gemv.w2": 0, "moe_gemm.w13": 0, "moe_gemm.w2": 0,
            "moe_combine": 0}

#: Lanes a decode launch takes (the kernel's rows of one expert; a larger
#: batch launches in groups of this many lanes), and the longest input row
#: it quantizes.
MAX_LANES = 8
MAX_IN = 3072

#: Per device, one int32 counter per layer of the distinct experts the
#: decode GEMV read, summed over steps.
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
MAX_LAYERS = 1024


def expert_counter(device) -> torch.Tensor:
    """The device's counters of distinct experts read, one per layer."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _COUNTERS:
        _COUNTERS[device] = torch.zeros((MAX_LAYERS,), dtype=torch.int32, device=device)
    return _COUNTERS[device]


def expert_reads() -> Dict[str, int]:
    """The counters' totals by layer (``moe_gemv.experts.<layer>``), where
    non-zero; reading a card's synchronises it."""
    out = {}
    for t in _COUNTERS.values():
        for i, n in enumerate(t.tolist()):
            if n:
                out[f"moe_gemv.experts.{i}"] = int(n)
    return out


def reset_expert_reads() -> None:
    for t in _COUNTERS.values():
        t.zero_()


@dataclass
class MoEWeights:
    """One layer's experts in the kernel layout (see the module docstring)."""

    w13: torch.Tensor
    sz13: torch.Tensor
    w2: torch.Tensor
    sz2: torch.Tensor
    gs13: int  # the group size of gate and up
    gs2: int  # of down

    @classmethod
    def from_experts(cls, experts) -> "MoEWeights":
        """From a list of ``{"w1", "w3", "w2"}`` int4 rowpack leaves."""
        gs13, gs2 = experts[0]["w1"]["group_size"], experts[0]["w2"]["group_size"]
        w13, sz13, w2, sz2 = [], [], [], []
        for ex in experts:
            if (ex["w1"]["group_size"], ex["w3"]["group_size"], ex["w2"]["group_size"]) != (
                    gs13, gs13, gs2):
                raise ValueError("every expert's leaves of a kind take one group size")
            g = qmm.rowpack_to_gemv(ex["w1"]["w"], ex["w1"]["scales"], ex["w1"]["zeros"])
            u = qmm.rowpack_to_gemv(ex["w3"]["w"], ex["w3"]["scales"], ex["w3"]["zeros"])
            w13.append(torch.stack([g[0], u[0]], dim=1).flatten(0, 1))
            sz13.append(torch.stack([g[1], u[1]], dim=1).flatten(0, 1))
            d = qmm.rowpack_to_gemv(ex["w2"]["w"], ex["w2"]["scales"], ex["w2"]["zeros"])
            w2.append(d[0])
            sz2.append(d[1])
        return cls(torch.stack(w13), torch.stack(sz13), torch.stack(w2), torch.stack(sz2),
                   gs13, gs2)

    @property
    def n_experts(self) -> int:
        return self.w13.shape[0]

    def tensors(self):
        return (self.w13, self.sz13, self.w2, self.sz2)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def swiglu_pairs(gu: torch.Tensor) -> torch.Tensor:
    """bf16 ``silu(gate) * up`` of interleaved gate/up columns [..., 2F]."""
    return torch.nn.functional.silu(gu[..., 0::2]) * gu[..., 1::2]


def combine(y: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """bf16 ``sum_k wts[:, k] * y[:, k]`` of rows y [N, K, D] (f32 or bf16)
    with f32 weights [N, K], each product and sum rounded in k order."""
    acc = wts[:, 0:1] * y[:, 0].float()
    for k in range(1, y.shape[1]):
        acc = acc + wts[:, k:k + 1] * y[:, k].float()
    return acc.to(torch.bfloat16)


def moe_decode_plain(x, ids, wts, mw: MoEWeights, counter=None):
    """Plain version of ``moe_decode`` (any device): every pair (b, k)
    through K1's plain function (``qmm.w4a8_gemv_plain``) on expert
    ``ids[b, k]``, SwiGLU and the combine rounded as the kernels round;
    ``counter`` (a one-element view) gains the distinct experts."""
    B, K = ids.shape
    rows = []
    for b in range(B):
        for k in range(K):
            e = ids[b, k]
            gu = qmm.w4a8_gemv_plain(x[b:b + 1], mw.w13[e], mw.sz13[e], mw.gs13)
            h = swiglu_pairs(gu.to(torch.bfloat16))
            rows.append(qmm.w4a8_gemv_plain(h, mw.w2[e], mw.sz2[e], mw.gs2))
    if counter is not None:  # no host read: the step may be under capture
        hit = torch.zeros((mw.n_experts,), dtype=torch.bool, device=ids.device)
        counter += hit.scatter_(0, ids.reshape(-1), True).sum().to(counter.dtype)
    return combine(torch.cat(rows).reshape(B, K, -1), wts)


# --------------------------------------------------------------------------
# The grouped decode GEMV
# --------------------------------------------------------------------------


def _fns():
    lib = _build.library("moe_gemv")
    gate_up, down = lib.moe_gate_up, lib.moe_down
    if gate_up.argtypes is None:
        gate_up.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        gate_up.restype = ctypes.c_int
        down.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        down.restype = ctypes.c_int
    return gate_up, down


TILE_COLS = 32  # csrc/moe_gemv.cu's kCols


def arrive_buffer(out_features: int, device) -> torch.Tensor:
    """The down launch's per-tile arrival counts (zero between launches)."""
    return torch.zeros((-(-out_features // TILE_COLS),), dtype=torch.int32, device=device)


def moe_decode(x, ids, wts, mw: MoEWeights, *, layer: int, arrive=None) -> torch.Tensor:
    """The experts' output [B, D] bf16 for decode rows x [B, D] bf16, each
    lane's K experts ``ids`` [B, K] (int64, distinct within a lane, as top k
    gives them: a group's lanes then put at most 8 rows on one expert, all
    that the kernel holds) and weights ``wts`` [B, K] (f32), both left on
    the device by the router. ``layer`` indexes the layer's
    distinct-experts counter; ``arrive`` is the layer's arrival buffer
    (``arrive_buffer``).

    CPU tensors take the plain version. CUDA tensors launch the two kernels
    for each group of up to ``MAX_LANES`` lanes (one group at B <= 8; a
    lane's combine reads only its own K rows, so the groups give the batch's
    bits, and the counter gains each group's distinct experts, which is what
    the groups read); any input the kernels do not take raises."""
    counter = expert_counter(x.device)[layer:layer + 1]
    B, K = ids.shape
    if x.device.type == "cpu":
        return moe_decode_plain(x, ids, wts, mw, counter)
    E, F2, D2 = mw.w13.shape
    D, F = 2 * D2, F2 // 2
    if x.dtype != torch.bfloat16 or tuple(x.shape) != (B, D) or not x.is_contiguous():
        raise ValueError(f"moe_decode: x {tuple(x.shape)} {x.dtype} for dim {D}")
    if ids.dtype != torch.int64 or wts.dtype != torch.float32 or tuple(wts.shape) != (B, K):
        raise ValueError(f"moe_decode: ids {ids.dtype} / weights {wts.dtype} {tuple(wts.shape)}")
    if (max(D, F) > MAX_IN or D % 32 or F % 32 or mw.gs13 % 32 or mw.gs2 % 32 or D % mw.gs13
            or F % mw.gs2):
        raise ValueError(f"moe_decode: widths {D} / {F} at group sizes {mw.gs13} / {mw.gs2}")
    if tuple(mw.w2.shape) != (E, D, F // 2):
        raise ValueError(f"moe_decode: down weights {tuple(mw.w2.shape)}")
    if arrive is None or arrive.numel() < -(-D // TILE_COLS) or arrive.dtype != torch.int32:
        raise ValueError("moe_decode: needs the layer's arrival buffer (arrive_buffer)")
    ids, wts = ids.contiguous(), wts.contiguous()
    dev, st = x.device, _build.stream_ptr(x.device)
    gate_up, down = _fns()
    out = torch.empty((B, D), dtype=torch.bfloat16, device=dev)
    for b0 in range(0, B, MAX_LANES):
        n = min(MAX_LANES, B - b0)
        xg, ig, wg, og = x[b0:b0 + n], ids[b0:b0 + n], wts[b0:b0 + n], out[b0:b0 + n]
        h = torch.empty((n * K, F), dtype=torch.bfloat16, device=dev)
        _build.check(gate_up(xg.data_ptr(), ig.data_ptr(), mw.w13.data_ptr(),
                             mw.sz13.data_ptr(), h.data_ptr(), counter.data_ptr(), n, K, E, D,
                             2 * F, mw.gs13, st), "moe_gate_up")
        LAUNCHES["moe_gemv.w13"] += 1
        ws = torch.empty((n * K, D), dtype=torch.float32, device=dev)
        _build.check(down(h.data_ptr(), ig.data_ptr(), wg.data_ptr(), mw.w2.data_ptr(),
                          mw.sz2.data_ptr(), ws.data_ptr(), og.data_ptr(), arrive.data_ptr(),
                          n, K, E, F, D, mw.gs2, st), "moe_down")
        LAUNCHES["moe_gemv.w2"] += 1
    return out


# --------------------------------------------------------------------------
# Prefill
# --------------------------------------------------------------------------


#: Rows of one expert a prefill tile holds (``csrc/moe_gemm.cu``'s kBN, the
#: wgmma's N); an expert's last tile is masked at its rows.
TILE_ROWS = 256
#: Weight columns a GEMM item takes (the kernel's kBM) and inputs a step.
ITEM_COLS, STEP_IN = 128, 64


class Schedule(NamedTuple):
    """A prefill's pairs sorted by expert (``dispatch``), all on ids' device.

    ``pair`` int32 [N K]: the pair (``n K + k``) of each sorted row, each
    expert's rows in token order; ``src`` int32 [N K]: its token;
    ``offsets`` int64 [E + 1]: each expert's first sorted row; ``tiles``
    int32 [slots, 3]: (expert, first sorted row, rows) of every tile of at
    most ``tile`` rows of one expert, by expert and row, then unused slots
    (expert E - 1, first N K, rows 0), ``slots`` = ceil(N K / tile) + E."""

    pair: torch.Tensor
    src: torch.Tensor
    offsets: torch.Tensor
    tiles: torch.Tensor


def dispatch(ids: torch.Tensor, n_experts: int, tile: int = TILE_ROWS) -> Schedule:
    """The schedule of a prefill's top-k ``ids`` [N, K] (int64) over
    ``n_experts``: a stable sort of the pairs by expert, an exclusive cumsum
    of the counts, and the tiles. Device ops only (no host read): the tile
    list has ceil(N K / tile) + E slots, a bound on the tiles any counts
    need."""
    N, K = ids.shape
    E, dev = n_experts, ids.device
    flat = ids.reshape(-1)
    keys, order = torch.sort(flat, stable=True)
    experts = torch.arange(E + 1, device=dev, dtype=flat.dtype)
    offsets = torch.searchsorted(keys, experts)  # exclusive cumsum of the counts
    counts = offsets[1:] - offsets[:-1]
    per = (counts + tile - 1) // tile
    ends = torch.cumsum(per, 0)
    slot = torch.arange(-(-N * K // tile) + E, device=dev, dtype=ends.dtype)
    e = torch.searchsorted(ends, slot, right=True)  # E past the last tile
    used = e < E
    e = e.clamp(max=E - 1)
    j = slot - (ends[e] - per[e])  # the tile's index within its expert
    first = torch.where(used, offsets[e] + j * tile, N * K)
    rows = torch.where(used, (counts[e] - j * tile).clamp(max=tile), 0)
    tiles = torch.stack([e, first, rows], dim=1).to(torch.int32)
    return Schedule(order.to(torch.int32), (order // K).to(torch.int32), offsets, tiles)


def moe_gemm_plain(x, rowmap, tiles, w, sz, gs: int, out, *, swiglu: bool) -> None:
    """Plain version of ``moe_gemm`` (any device; reads the schedule on the
    host): each expert's tiles (consecutive sorted rows) as one bf16 matmul
    over its weights dequantized to bf16 (``qmm.dequantize_gemv``, all
    experts at once), with ``swiglu_pairs`` after gate and up."""
    wd = qmm.dequantize_gemv(w, sz, gs)
    spans: Dict[int, list] = {}
    for e, first, rows in tiles.tolist():
        if rows:
            spans.setdefault(e, [first, first])[1] = first + rows
    rowmap = rowmap.long()
    for e, (a, b) in spans.items():
        if swiglu:
            out[a:b] = swiglu_pairs(torch.matmul(x.index_select(0, rowmap[a:b]), wd[e]))
        else:
            out[rowmap[a:b]] = torch.matmul(x[a:b], wd[e])


def _prefill(x, ids, mw: MoEWeights, gemm) -> torch.Tensor:
    """The rows y [N, K, D] of every pair, each expert's rows through
    ``gemm`` twice over ``dispatch``'s schedule (the plain and the kernel
    path share it)."""
    N, K = ids.shape
    D, F = mw.w2.shape[1], mw.w13.shape[1] // 2
    sched = dispatch(ids, mw.n_experts)
    h = torch.empty((N * K, F), dtype=torch.bfloat16, device=x.device)
    gemm(x, sched.src, sched.tiles, mw.w13, mw.sz13, mw.gs13, h, swiglu=True)
    y = torch.empty((N * K, D), dtype=torch.bfloat16, device=x.device)
    gemm(h, sched.pair, sched.tiles, mw.w2, mw.sz2, mw.gs2, y, swiglu=False)
    return y.view(N, K, D)


def moe_prefill_plain(x, ids, wts, mw: MoEWeights) -> torch.Tensor:
    """Plain version of ``moe_prefill`` (any device): ``dispatch``'s
    schedule, each expert's rows through ``moe_gemm_plain`` (gate and up with
    SwiGLU, then down, each row put at its pair's place), and the pairs
    combined in k order (``combine``)."""
    return combine(_prefill(x, ids, mw, moe_gemm_plain), wts)


def _gemm_fns():
    lib = _build.library("moe_gemm")
    gemm, comb = lib.moe_gemm, lib.moe_combine
    if gemm.argtypes is None:
        gemm.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        gemm.restype = ctypes.c_int
        comb.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        comb.restype = ctypes.c_int
    return gemm, comb


def moe_gemm(x, rowmap, tiles, w, sz, gs: int, out, *, swiglu: bool) -> None:
    """One grouped launch of ``csrc/moe_gemm.cu`` over ``tiles`` (a
    ``Schedule``'s). ``swiglu``: x [N, IN] token rows gathered by ``rowmap``
    (the schedule's ``src``) through the interleaved gate and up ``w``/``sz``
    [E, 2F, ...], out h [rows, F]; else x the sorted h rows [rows, IN]
    through the down weights, out y [N K, OUT] at the rows ``rowmap`` (the
    schedule's ``pair``) gives."""
    E, OUT, IN2 = w.shape
    slots = tiles.shape[0]
    ctas = min(qmm.sm_count(x.device), slots * (OUT // ITEM_COLS))
    gemm, _ = _gemm_fns()
    _build.check(gemm(x.data_ptr(), rowmap.data_ptr(), tiles.data_ptr(), slots, w.data_ptr(),
                      sz.data_ptr(), out.data_ptr(), x.shape[0], E, 2 * IN2, OUT, gs,
                      int(swiglu), ctas, _build.stream_ptr(x.device)), "moe_gemm")
    LAUNCHES["moe_gemm.w13" if swiglu else "moe_gemm.w2"] += 1


def moe_combine(y, wts) -> torch.Tensor:
    """``combine`` of y [N, K, D] bf16 and wts [N, K] f32 by the kernel."""
    N, K, D = y.shape
    out = torch.empty((N, D), dtype=torch.bfloat16, device=y.device)
    _, comb = _gemm_fns()
    ctas = min(-(-N * D // 8 // 256), 16 * qmm.sm_count(y.device))
    _build.check(comb(y.data_ptr(), wts.data_ptr(), out.data_ptr(), N, K, D, ctas,
                      _build.stream_ptr(y.device)), "moe_combine")
    LAUNCHES["moe_combine"] += 1
    return out


def moe_prefill(x, ids, wts, mw: MoEWeights) -> torch.Tensor:
    """The experts' output [N, D] bf16 for prefill rows x [N, D] bf16, each
    row's K experts ``ids`` [N, K] (int64) and weights ``wts`` [N, K] (f32),
    as the router leaves them on the device.

    CPU tensors take the plain version. CUDA tensors take the three
    launches over ``dispatch``'s schedule (gate and up with SwiGLU, down,
    combine), with no host read; any input the kernels do not take raises."""
    if x.device.type == "cpu":
        return moe_prefill_plain(x, ids, wts, mw)
    N, K = ids.shape
    E, F2, D2 = mw.w13.shape
    D, F = 2 * D2, F2 // 2
    if x.dtype != torch.bfloat16 or tuple(x.shape) != (N, D):
        raise ValueError(f"moe_prefill: x {tuple(x.shape)} {x.dtype} for dim {D}")
    if ids.dtype != torch.int64 or wts.dtype != torch.float32 or tuple(wts.shape) != (N, K):
        raise ValueError(f"moe_prefill: ids {ids.dtype} / weights {wts.dtype} "
                         f"{tuple(wts.shape)}")
    if (D % STEP_IN or F % STEP_IN or mw.gs13 % STEP_IN or mw.gs2 % STEP_IN or D % mw.gs13
            or F % mw.gs2 or F2 % ITEM_COLS or D % ITEM_COLS):
        raise ValueError(f"moe_prefill: widths {D} / {F} at group sizes {mw.gs13} / {mw.gs2}")
    if tuple(mw.w2.shape) != (E, D, F // 2):
        raise ValueError(f"moe_prefill: down weights {tuple(mw.w2.shape)}")
    return moe_combine(_prefill(x.contiguous(), ids, mw, moe_gemm), wts.contiguous())
