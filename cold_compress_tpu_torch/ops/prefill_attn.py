"""Causal prefill attention with per-key summaries (kernel K4): wrapper and
plain version.

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
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .attention import AttnSummary, chunked_prefill_partial, finalize_summary, _plen

#: Launch count of the CUDA kernel (one per call; a call runs both passes).
LAUNCHES = {"flash_prefill_summary": 0}

HEAD_DIM = 128
BLOCK = 64


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
