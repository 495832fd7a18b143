"""Causal prefill attention with per-key summaries (kernel K4) or with the
FastGen hybrid profile (kernel K6): wrappers and plain versions.

Counterpart of ``cold_compress_tpu/ops/pallas_prefill.py``. The CUDA kernel
(``csrc/flash_prefill.cu``) replaces ``flash_prefill`` (pallas_prefill.py:167,
``_kernel``): pass 1 is causal GQA flash attention with the G query heads
folded into the rows (K/V never repeated), bf16 operands on the tensor cores,
p cast to bf16 before P.V, y in bf16; it keeps each row's softmax statistics
(m, l). Pass 2 gives each block one 64-key block and loops over the query
rows that see it, recomputing and normalising the scores and summing them
per key, weighted by validity / G (``cum``) and by the last ``obs_len``
positions / G (``obs``). Each key is written by one block, with no atomics,
so the sums are deterministic.

Bound on the H100: operations (~0.55 TFLOP of causal QK^T and PV per layer
at P = 8192, plus the pass-2 recompute, against ~100 MB of inputs). Design:
bf16 ``mma.sync`` tensor-core tiles from shared memory; no copy pipelining
yet.

K6 (``flash_profile``, the second entry point of the same source) replaces
``flash_profile`` (pallas_prefill.py:281): the same pass 1, and a pass 2
that sums the normalised probabilities into the raw hybrid profile
accumulators ``cum`` and ``wcols`` (``profile_partial`` below is their
plain version) instead of ``cum``/``obs``. The hybrid prefill runs it in
place of K4.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .attention import NEG_INF, AttnSummary, chunked_prefill_partial, finalize_summary, _plen

#: Launch counts of the CUDA kernels (one per call; a call runs both passes).
LAUNCHES = {"flash_prefill_summary": 0, "flash_profile": 0}

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


def _lib():
    fn = _build.library("flash_prefill").flash_prefill_summary
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def flash_prefill(q, k, v, prompt_len, need_summary: bool = True, obs_len: int = 16):
    """Returns (y [B, H, P, D], summary | None) with summary
    ``{obs_mean, cum_mean}`` [B, KVH, P] f32, the contract of
    ops/attention.py::prefill_attention.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    any input it does not take raises."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, prompt_len, need_summary, obs_len)
    B, H, P, D = q.shape
    KVH = k.shape[1]
    if not flash_prefill_supported(q.shape) or H % KVH:
        raise ValueError(f"flash_prefill: unsupported q {tuple(q.shape)}")
    if tuple(k.shape) != (B, KVH, P, D) or tuple(v.shape) != (B, KVH, P, D):
        raise ValueError("flash_prefill: k/v shape does not match q")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_prefill: inputs on different devices")
    qb = q.to(torch.bfloat16).contiguous()
    kb = k.to(torch.bfloat16).contiguous()
    vb = v.to(torch.bfloat16).contiguous()
    plen = _plen(prompt_len, B, q.device).contiguous()
    dev = q.device
    G = H // KVH
    y = torch.empty((B, H, P, D), dtype=torch.bfloat16, device=dev)
    mbuf = torch.empty((B, KVH, P * G), dtype=torch.float32, device=dev)
    lbuf = torch.empty_like(mbuf)
    cum = torch.empty((B, KVH, P), dtype=torch.float32, device=dev)
    obs = torch.empty_like(cum)
    status = _lib()(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), y.data_ptr(),
        mbuf.data_ptr(), lbuf.data_ptr(), plen.data_ptr(), cum.data_ptr(),
        obs.data_ptr(), B, H, KVH, P, 1.0 / math.sqrt(D), obs_len,
        int(need_summary), _build.stream_ptr(dev),
    )
    _build.check(status, "flash_prefill_summary")
    LAUNCHES["flash_prefill_summary"] += 1
    y = y.to(q.dtype)
    if not need_summary:
        return y, None
    summary: AttnSummary = finalize_summary(cum, obs, plen, P, obs_len)
    return y, summary


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


def _lib_profile():
    fn = _build.library("flash_prefill").flash_profile
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 4
            + [ctypes.c_float]
            + [ctypes.c_int] * 5
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def flash_profile(q, k, v, prompt_len, window_lens=()):
    """Causal attention plus the FastGen profile: returns (y [B, H, P, D],
    cum [B, KVH, P], wcols [W, B, KVH, P]) with cum and wcols RAW (not
    divided by the number of queries), the contract of the JAX package's
    ``ops/pallas_prefill.py::flash_profile``.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    any input it does not take raises."""
    window_lens = tuple(int(w) for w in window_lens)
    if q.device.type == "cpu":
        return flash_profile_plain(q, k, v, prompt_len, window_lens)
    B, H, P, D = q.shape
    KVH = k.shape[1]
    if not flash_prefill_supported(q.shape) or H % KVH:
        raise ValueError(f"flash_profile: unsupported q {tuple(q.shape)}")
    if tuple(k.shape) != (B, KVH, P, D) or tuple(v.shape) != (B, KVH, P, D):
        raise ValueError("flash_profile: k/v shape does not match q")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_profile: inputs on different devices")
    if len(window_lens) > MAX_WINDOWS or any(w < 1 for w in window_lens):
        raise ValueError(f"flash_profile: window lengths {window_lens} (at most "
                         f"{MAX_WINDOWS}, each at least 1)")
    qb = q.to(torch.bfloat16).contiguous()
    kb = k.to(torch.bfloat16).contiguous()
    vb = v.to(torch.bfloat16).contiguous()
    plen = _plen(prompt_len, B, q.device).contiguous()
    dev = q.device
    G = H // KVH
    y = torch.empty((B, H, P, D), dtype=torch.bfloat16, device=dev)
    mbuf = torch.empty((B, KVH, P * G), dtype=torch.float32, device=dev)
    lbuf = torch.empty_like(mbuf)
    cum = torch.empty((B, KVH, P), dtype=torch.float32, device=dev)
    wcols = torch.empty((len(window_lens), B, KVH, P), dtype=torch.float32, device=dev)
    wl = list(window_lens) + [1] * (MAX_WINDOWS - len(window_lens))
    status = _lib_profile()(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), y.data_ptr(), mbuf.data_ptr(),
        lbuf.data_ptr(), plen.data_ptr(), cum.data_ptr(), wcols.data_ptr(), B, H, KVH, P,
        1.0 / math.sqrt(D), len(window_lens), *wl, _build.stream_ptr(dev),
    )
    _build.check(status, "flash_profile")
    LAUNCHES["flash_profile"] += 1
    return y.to(q.dtype), cum, wcols
