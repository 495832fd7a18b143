"""Causal prefill attention with per-key summaries (kernel K4) or with the
FastGen hybrid profile (kernel K6): wrappers and plain versions.

Counterpart of ``cold_compress_tpu/ops/pallas_prefill.py``. The CUDA kernel
(``csrc/flash_prefill.cu``) replaces ``flash_prefill`` (pallas_prefill.py:167,
``_kernel``): pass 1 is causal GQA flash attention with the G query heads
folded into the rows (K/V never repeated), bf16 operands on the tensor cores
(``mma.sync`` fed by ``ldmatrix``, 128 rows per CTA, K/V tiles in a
three-stage ``cp.async`` ring, the longest causal row blocks first), the unnormalised
probabilities cast to bf16 before P.V, y in bf16; it keeps each row's
softmax statistics. Pass 2 cuts the work into items of one 128-key block
against one segment of at most ``seg_rows`` query rows
(``colsum_segments``), recomputes and normalises the scores and sums them
per key, weighted by validity / G (``cum``) and by the last ``obs_len``
positions / G (``obs``), into a per-segment workspace that a third small
launch sums in segment order: no atomics, so the sums are deterministic.

Bound on the H100: operations (~0.55 TFLOP of causal QK^T and PV per layer
at P = 8192, plus the pass-2 recompute, against ~100 MB of inputs).

K6 (``flash_profile``, the second entry point of the same source) replaces
``flash_profile`` (pallas_prefill.py:281): the same pass 1, and pass 2
instantiated over the raw hybrid profile accumulators ``cum`` and
``wcols`` (``profile_partial`` below is their plain version) instead of
``cum``/``obs``. The hybrid prefill runs it in place of K4.

Both kernels also take a block of query rows at a global offset against a
longer key sequence (``flash_prefill_partial``, ``flash_profile_partial``):
the counterpart of ``ops/attention.py::chunked_prefill_partial`` and
``caches/hybrid.py::_profile_partial``, which the JAX package's sequence-
and pipeline-parallel prefills (``parallel/sp.py``, ``parallel/pp.py``)
call per shard or chunk. They return the raw per-key sums over the block's
rows, which the ranks add up. K and V may be a row slice of a longer buffer
(the pipeline's K/V so far), read in place. At ``q_offset = 0`` with as many
rows as keys they run exactly K4's and K6's instructions.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .attention import NEG_INF, AttnSummary, chunked_prefill_partial, finalize_summary, _plen

#: Launch counts of the CUDA kernels (one per call; a call runs both passes).
LAUNCHES = {"flash_prefill_summary": 0, "flash_profile": 0, "flash_prefill_partial": 0,
            "flash_profile_partial": 0, "flash_prefill_window": 0}

HEAD_DIM = 128
BLOCK = 64
#: Distinct recent-window lengths the profile kernel sums at once.
MAX_WINDOWS = 4


def flash_prefill_supported(q_shape) -> bool:
    """Shapes the kernel takes: head_dim 128 and a padded length that is a
    multiple of the 64-key tile."""
    B, H, P, D = q_shape
    return D == HEAD_DIM and P % BLOCK == 0 and P >= BLOCK


def flash_prefill_plain(q, k, v, prompt_len, need_summary=True, obs_len=16):
    """Plain PyTorch version: the chunked math of ops/attention.py (f32
    scores and softmax over bf16 operands, normalised probabilities cast to
    bf16 before P.V)."""
    y, cum, obs = chunked_prefill_partial(
        q, k, v, prompt_len, need_summary=need_summary, obs_len=obs_len
    )
    if not need_summary:
        return y, None
    plen = _plen(prompt_len, q.shape[0], q.device)
    return y, finalize_summary(cum, obs, plen, k.shape[2], obs_len)


#: Pass 2 cuts the P*G folded query rows into at most this many segments,
#: and the keys into blocks of this many (the last one may reach past P).
MAX_SEGMENTS = 32
KEYS_PER_ITEM = 128


def colsum_segments(P: int, G: int):
    """(seg_rows, n_seg) of pass 2: segments of ``seg_rows`` folded rows (a
    multiple of 64), at most ``MAX_SEGMENTS`` of them, covering the P * G
    folded rows of P query positions."""
    rows = P * G
    seg_rows = -(-rows // (MAX_SEGMENTS * BLOCK)) * BLOCK
    return seg_rows, -(-rows // seg_rows)


def colsum_items(P: int, G: int, prompt_len: int, q_offset: int = 0, Pk=None):
    """Pass 2's non-empty work items as the kernel cuts them: (key block,
    segment, first row, end row) for every 128-key block and segment whose
    valid rows see the block; P query positions at ``q_offset`` (rows are
    local, ``prompt_len`` global) against ``Pk`` keys (default P)."""
    Pk = P if Pk is None else Pk
    seg_rows, n_seg = colsum_segments(P, G)
    row_end = max(0, min(prompt_len - q_offset, P)) * G
    items = []
    for kb in range(-(-min(Pk, q_offset + P) // KEYS_PER_ITEM)):
        for s in range(n_seg):
            r0 = max(s * seg_rows, max(kb * KEYS_PER_ITEM - q_offset, 0) * G)
            r1 = min((s + 1) * seg_rows, row_end)
            if r0 < r1:
                items.append((kb, s, r0, r1))
    return items


#: C argument types after the pointers: (B, H, KVH, Pq, Pk, q_offset,
#: kv_rows), the scale, then each entry's own ints, then the stream.
_ARGS = {"flash_fwd": (6, 0), "flash_colsum": (7, 9), "flash_fwd_window": (6, 1)}


def _fn(name):
    fn = getattr(_build.library("flash_prefill"), name)
    if fn.argtypes is None:
        n_ptr, n_int = _ARGS[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [ctypes.c_float]
                       + [ctypes.c_int] * n_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def kv_rows(t: torch.Tensor) -> int:
    """Rows between consecutive (batch, KV head) planes of ``t`` [B, KVH,
    Pk, D] (a size-1 axis has no meaningful stride), or 0 where the kernel
    cannot read ``t`` in place: rows must be D apart and the planes evenly
    spaced, at least Pk rows apart."""
    B, KVH, Pk, D = t.shape
    plane = t.stride(1) if KVH > 1 else (t.stride(0) if B > 1 else Pk * D)
    ok = (t.stride(3) == 1 and t.stride(2) == D and plane % D == 0 and plane >= Pk * D
          and (B == 1 or KVH == 1 or t.stride(0) == KVH * plane))
    return plane // D if ok else 0


def _kv_plane(t: torch.Tensor) -> torch.Tensor:
    """``t`` in bf16 as the kernel reads it: a row slice of a longer
    contiguous buffer as it is (``kv_rows``), anything else copied."""
    t = t.to(torch.bfloat16)
    return t if kv_rows(t) else t.contiguous()


def _check_block(name, q, k, v, q_offset: int):
    """bf16 (q, k, v, kv_rows) for a block of q rows at ``q_offset`` against
    k/v's keys; raises on what the kernel does not take."""
    B, H, Pq, D = q.shape
    KVH, Pk = k.shape[1], k.shape[2]
    if not flash_prefill_supported(q.shape) or H % KVH:
        raise ValueError(f"{name}: unsupported q {tuple(q.shape)}")
    if tuple(k.shape) != (B, KVH, Pk, D) or tuple(v.shape) != (B, KVH, Pk, D):
        raise ValueError(f"{name}: k/v shape does not match q")
    if Pk % BLOCK or q_offset < 0 or q_offset % BLOCK or q_offset + Pq > Pk:
        raise ValueError(f"{name}: {Pq} query rows at offset {q_offset} against {Pk} keys "
                         f"(each a multiple of {BLOCK}, every row's keys present)")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: inputs on different devices")
    kb, vb = _kv_plane(k), _kv_plane(v)
    if kv_rows(kb) != kv_rows(vb):
        kb, vb = kb.contiguous(), vb.contiguous()
    return q.to(torch.bfloat16).contiguous(), kb, vb, kv_rows(kb)


def _whole_prompt(name, q, k):
    """K4 and K6 over a whole prompt take as many query rows as keys."""
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: k/v shape does not match q")


def flash_pass1(q, k, v, q_offset: int = 0):
    """Pass 1 alone on bf16 CUDA tensors (no launch count): y [B, H, Pq, D]
    bf16 and each folded row's softmax max (base 2) and 1 / sum, [B, KVH,
    Pq*G] f32, for q's rows at ``q_offset`` against k/v's Pk keys (planes
    ``kv_rows(k)`` rows apart)."""
    B, H, Pq, D = q.shape
    KVH, Pk = k.shape[1], k.shape[2]
    dev = q.device
    y = torch.empty((B, H, Pq, D), dtype=torch.bfloat16, device=dev)
    mbuf = torch.empty((B, KVH, Pq * (H // KVH)), dtype=torch.float32, device=dev)
    ilbuf = torch.empty_like(mbuf)
    status = _fn("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), mbuf.data_ptr(),
        ilbuf.data_ptr(), B, H, KVH, Pq, Pk, q_offset, kv_rows(k),
        math.log2(math.e) / math.sqrt(D), _build.stream_ptr(dev),
    )
    _build.check(status, "flash_fwd")
    return y, mbuf, ilbuf


def flash_prefill_window(q, k, v, window: int):
    """Pass 1 over a sliding window (``flash_fwd_window``): y [B, H, P, D]
    of the whole prompt, the row at position i attending to keys j with
    ``i - window < j <= i``. Key tiles wholly left of a CTA's rows' windows
    are skipped, the edge tile masked. No summary: a window layer's cache
    keeps the last rows. One count under ``flash_prefill_window``.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    any input it does not take raises."""
    _whole_prompt("flash_prefill_window", q, k)
    if window < 1:
        raise ValueError(f"flash_prefill_window: window {window}")
    if q.device.type == "cpu":
        y, _, _ = chunked_prefill_partial(q, k, v, q.shape[2], window=window)
        return y
    qb, kb, vb, _ = _check_block("flash_prefill_window", q, k, v, 0)
    B, H, P, D = qb.shape
    KVH = kb.shape[1]
    dev = q.device
    y = torch.empty((B, H, P, D), dtype=torch.bfloat16, device=dev)
    mbuf = torch.empty((B, KVH, P * (H // KVH)), dtype=torch.float32, device=dev)
    ilbuf = torch.empty_like(mbuf)
    status = _fn("flash_fwd_window")(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), y.data_ptr(), mbuf.data_ptr(),
        ilbuf.data_ptr(), B, H, KVH, P, P, 0, kv_rows(kb), math.log2(math.e) / math.sqrt(D),
        int(window), _build.stream_ptr(dev),
    )
    _build.check(status, "flash_fwd_window")
    LAUNCHES["flash_prefill_window"] += 1
    return y.to(q.dtype)


def flash_pass2(q, k, mbuf, ilbuf, plen, obs_len: int = 16, window_lens=None,
                q_offset: int = 0):
    """Pass 2 and its reduction alone (no launch count): [2, B, KVH, Pk] f32
    (cum, obs) for K4, or with ``window_lens`` [1 + W, B, KVH, Pk] (cum, one
    sum per window) for K6, over q's rows at ``q_offset``."""
    B, H, Pq, D = q.shape
    KVH, Pk = k.shape[1], k.shape[2]
    G = H // KVH
    dev = q.device
    seg_rows, n_seg = colsum_segments(Pq, G)
    n_acc = 2 if window_lens is None else 1 + len(window_lens)
    ws = torch.empty((n_acc, n_seg, B, KVH, Pk), dtype=torch.float32, device=dev)
    out = torch.empty((n_acc, B, KVH, Pk), dtype=torch.float32, device=dev)
    wl = list(window_lens or ()) + [1] * (MAX_WINDOWS - len(window_lens or ()))
    status = _fn("flash_colsum")(
        q.data_ptr(), k.data_ptr(), mbuf.data_ptr(), ilbuf.data_ptr(), plen.data_ptr(),
        ws.data_ptr(), out.data_ptr(), B, H, KVH, Pq, Pk, q_offset, kv_rows(k),
        math.log2(math.e) / math.sqrt(D), seg_rows, n_seg, int(window_lens is not None),
        obs_len, len(window_lens or ()), *wl, _build.stream_ptr(dev),
    )
    _build.check(status, "flash_colsum")
    return out


def _prefill_block(counter, q, k, v, prompt_len, q_offset, need_summary, obs_len):
    """K4 over q's rows at ``q_offset``: (y, cum, obs), the sums raw (None
    without ``need_summary``); one count under ``counter`` per launch."""
    if q.device.type == "cpu":
        y, cum, obs = chunked_prefill_partial(q, k, v, prompt_len, q_offset=q_offset,
                                              need_summary=need_summary, obs_len=obs_len)
        return (y, cum, obs) if need_summary else (y, None, None)
    qb, kb, vb, _ = _check_block(counter, q, k, v, q_offset)
    plen = _plen(prompt_len, q.shape[0], q.device).contiguous()
    y, mbuf, ilbuf = flash_pass1(qb, kb, vb, q_offset)
    sums = (flash_pass2(qb, kb, mbuf, ilbuf, plen, obs_len, q_offset=q_offset)
            if need_summary else (None, None))
    LAUNCHES[counter] += 1
    return y.to(q.dtype), sums[0], sums[1]


def flash_prefill(q, k, v, prompt_len, need_summary: bool = True, obs_len: int = 16):
    """Returns (y [B, H, P, D], summary | None) with summary
    ``{obs_mean, cum_mean}`` [B, KVH, P] f32, the contract of
    ops/attention.py::prefill_attention: the whole prompt as one block at
    offset 0, its sums turned into means.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    any input it does not take raises."""
    _whole_prompt("flash_prefill", q, k)
    y, cum, obs = _prefill_block("flash_prefill_summary", q, k, v, prompt_len, 0,
                                 need_summary, obs_len)
    if not need_summary:
        return y, None
    plen = _plen(prompt_len, q.shape[0], q.device)
    summary: AttnSummary = finalize_summary(cum, obs, plen, q.shape[2], obs_len)
    return y, summary


def flash_prefill_partial(q, k, v, prompt_len, q_offset: int = 0, need_summary: bool = True,
                          obs_len: int = 16):
    """K4 over a block of query rows: q [B, H, Pq, D] at global positions
    ``q_offset .. q_offset + Pq - 1`` against k/v [B, KVH, Pk, D]. Returns
    (y [B, H, Pq, D], cum, obs) with cum/obs [B, KVH, Pk] f32 the RAW sums
    of the G-averaged probabilities over the block's valid / last-``obs_len``
    rows (None without ``need_summary``): the contract of the JAX package's
    ``ops/attention.py::chunked_prefill_partial``. Blocks that cover a
    prompt add up to its sums (``finalize_summary`` turns them into means).

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    any input it does not take raises (Pq, Pk and ``q_offset`` multiples of
    64, ``q_offset + Pq <= Pk``)."""
    return _prefill_block("flash_prefill_partial", q, k, v, prompt_len, q_offset,
                          need_summary, obs_len)


# --------------------------------------------------------------------------
# K6: attention plus the FastGen hybrid profile
# --------------------------------------------------------------------------


def profile_partial(q, k, prompt_len, window_lens, q_offset: int = 0, chunk_size: int = 512):
    """The raw FastGen profile accumulators of a query block at global
    position ``q_offset`` against the full key sequence
    (``caches/hybrid.py::_profile_partial`` of the JAX package).

    Returns (cum [B, KVH, P], wcols [W, B, KVH, P]) f32: per key, the sum
    over this block's valid queries of the G-averaged normalised
    probabilities, and the same restricted to the queries whose recent
    window of each length w in ``window_lens`` holds the key. Scores are
    f32 over bf16 operands; queries stream ``chunk_size`` rows at a time, so
    the largest temporary is B * H * chunk_size * P f32."""
    B, H, Pq, D = q.shape
    KVH, P = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = q.reshape(B, KVH, G, Pq, D).to(torch.bfloat16)
    kf = k.to(torch.bfloat16).float()
    plen = _plen(prompt_len, B, dev)
    key_pos = torch.arange(P, device=dev)
    cum = torch.zeros((B, KVH, P), dtype=torch.float32, device=dev)
    wcols = torch.zeros((len(window_lens), B, KVH, P), dtype=torch.float32, device=dev)
    for c0 in range(0, Pq, chunk_size):
        qc = qg[:, :, :, c0 : c0 + chunk_size].float()
        q_pos = q_offset + c0 + torch.arange(qc.shape[3], device=dev)
        scores = torch.einsum("bkgld,bksd->bkgls", qc, kf) * scale
        causal = key_pos[None, :] <= q_pos[:, None]  # [n, P]
        scores = scores.masked_fill(~causal[None, None, None], NEG_INF)
        pooled = torch.softmax(scores, dim=-1).mean(dim=2)  # [B, KVH, n, P]
        del scores
        q_valid = (q_pos[None, :] < plen[:, None]).float()  # [B, n]
        cum += torch.einsum("bkcs,bc->bks", pooled, q_valid)
        for wi, w in enumerate(window_lens):
            in_window = causal & (key_pos[None, :] >= q_pos[:, None] + 1 - w)
            wcols[wi] += torch.einsum(
                "bkcs,bc->bks", torch.where(in_window[None, None], pooled, 0.0), q_valid
            )
    return cum, wcols


def flash_profile_plain(q, k, v, prompt_len, window_lens=()):
    """Plain PyTorch version of K6: the chunked prefill (y) and
    ``profile_partial`` (cum, wcols)."""
    y, _, _ = chunked_prefill_partial(q, k, v, prompt_len, need_summary=False)
    cum, wcols = profile_partial(q, k, prompt_len, tuple(window_lens))
    return y, cum, wcols


def _profile_block(counter, q, k, v, prompt_len, window_lens, q_offset):
    """K6 over q's rows at ``q_offset``: (y, cum, wcols), the sums raw; one
    count under ``counter`` per launch."""
    window_lens = tuple(int(w) for w in window_lens)
    if q.device.type == "cpu":
        y, _, _ = chunked_prefill_partial(q, k, v, prompt_len, q_offset=q_offset,
                                          need_summary=False)
        cum, wcols = profile_partial(q, k, prompt_len, window_lens, q_offset=q_offset)
        return y, cum, wcols
    qb, kb, vb, _ = _check_block(counter, q, k, v, q_offset)
    if len(window_lens) > MAX_WINDOWS or any(w < 1 for w in window_lens):
        raise ValueError(f"{counter}: window lengths {window_lens} (at most "
                         f"{MAX_WINDOWS}, each at least 1)")
    plen = _plen(prompt_len, q.shape[0], q.device).contiguous()
    y, mbuf, ilbuf = flash_pass1(qb, kb, vb, q_offset)
    sums = flash_pass2(qb, kb, mbuf, ilbuf, plen, window_lens=window_lens, q_offset=q_offset)
    LAUNCHES[counter] += 1
    return y.to(q.dtype), sums[0], sums[1:]


def flash_profile(q, k, v, prompt_len, window_lens=()):
    """Causal attention plus the FastGen profile: returns (y [B, H, P, D],
    cum [B, KVH, P], wcols [W, B, KVH, P]) with cum and wcols RAW (not
    divided by the number of queries), the contract of the JAX package's
    ``ops/pallas_prefill.py::flash_profile``: the whole prompt as one block
    at offset 0.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    any input it does not take raises."""
    _whole_prompt("flash_profile", q, k)
    return _profile_block("flash_profile", q, k, v, prompt_len, window_lens, 0)


def flash_profile_partial(q, k, v, prompt_len, window_lens=(), q_offset: int = 0):
    """K6 over a block of query rows at ``q_offset`` (as
    ``flash_prefill_partial``): returns (y [B, H, Pq, D], cum [B, KVH, Pk],
    wcols [W, B, KVH, Pk]), the raw profile sums over the block's valid
    rows, the JAX package's ``chunked_prefill_partial`` and
    ``caches/hybrid.py::_profile_partial`` of the block together.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    any input it does not take raises."""
    return _profile_block("flash_profile_partial", q, k, v, prompt_len, window_lens, q_offset)
