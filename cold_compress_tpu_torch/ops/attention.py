"""Grouped-query attention: masked decode attention with pooled
probabilities, and causal prefill with per-key summaries.

Counterpart of ``cold_compress_tpu/ops/attention.py`` (the plain math, no
kernel). GQA is a grouped einsum: repeated K/V heads are never built.
Prefill never builds the P x P map: it streams over query chunks and keeps
the O(P) per-key summaries the compressors consume.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

#: Per-key attention summaries produced during prefill:
#:   obs_mean [B, KVH, P]: mean attention from the last ``obs_len`` valid
#:       queries (SnapKV's observation window)
#:   cum_mean [B, KVH, P]: attention mass averaged over the queries that can
#:       see each key (heavy-hitter prefill seeding)
AttnSummary = Dict[str, torch.Tensor]


def gqa_attention(
    q: torch.Tensor,  # [B, H, L, D]
    k: torch.Tensor,  # [B, KVH, S, D]
    v: torch.Tensor,  # [B, KVH, S, D]
    mask: Optional[torch.Tensor] = None,  # bool, broadcastable to [B, KVH, G, L, S]
    scale: Optional[float] = None,
    return_attn: bool = False,
    attn_top_k: float = 1.0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Masked softmax attention with grouped queries.

    Returns ``(out [B, H, L, D], attn [B, KVH, L, S] | None)`` with ``attn``
    averaged over the G query heads of each KV head. Scores and softmax in
    f32 (operands promoted to f32, as XLA's f32-accumulated einsum).

    ``attn_top_k < 1`` (decode only) keeps the scores of the top
    ``round(attn_top_k * S)`` slots and masks the rest before the softmax;
    slots tying the k-th score are all kept (JAX ops/attention.py:61-71)."""
    B, H, L, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    G = H // KVH
    scale = (1.0 / math.sqrt(D)) if scale is None else scale
    qg = q.reshape(B, KVH, G, L, D).float()
    scores = torch.einsum("bkgld,bksd->bkgls", qg, k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    top_k = S if L > 1 else int(round(attn_top_k * S))
    if top_k < S:
        kth = torch.topk(scores, top_k, dim=-1).values[..., -1:]
        scores = torch.where(scores >= kth, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgls,bksd->bkgld", probs, v.float())
    out = out.reshape(B, H, L, D).to(q.dtype)
    attn = probs.mean(dim=2) if return_attn else None
    return out, attn


def prefill_attention(
    q: torch.Tensor,  # [B, H, P, D]
    k: torch.Tensor,  # [B, KVH, P, D]
    v: torch.Tensor,
    valid: torch.Tensor,  # bool [B, P]
    prompt_len,  # int or [B] int
    need_summary: bool = False,
    obs_len: int = 16,
    chunk_size: int = 256,
    window: int = 0,
) -> Tuple[torch.Tensor, Optional[AttnSummary]]:
    """Full causal self-attention over a (padded) prompt; with ``window``
    > 0 a sliding window's (the row at position i sees keys j with
    ``i - window < j <= i``), which takes no summary.

    Shapes the flash kernel takes (``ops/prefill_attn.py``: head_dim 128,
    P a multiple of its 64-row blocks) go to it (K4); others take the
    chunked math below, as the JAX package's gate routes them."""
    B, H, P, D = q.shape
    from .prefill_attn import flash_prefill, flash_prefill_supported, flash_prefill_window

    if window:
        if need_summary:
            raise ValueError("a sliding-window prefill takes no attention summary")
        if flash_prefill_supported(q.shape):
            return flash_prefill_window(q, k, v, window), None
        y, _, _ = chunked_prefill_partial(q, k, v, prompt_len, chunk_size=chunk_size,
                                          window=window)
        return y, None
    if flash_prefill_supported(q.shape):
        return flash_prefill(
            q, k, v, prompt_len, need_summary=need_summary, obs_len=obs_len
        )
    if not need_summary and P <= chunk_size:
        causal = torch.ones((P, P), dtype=torch.bool, device=q.device).tril()
        out, _ = gqa_attention(q, k, v, mask=causal[None, None, None])
        return out, None
    return _chunked_prefill(q, k, v, prompt_len, need_summary, obs_len, chunk_size)


def _plen(prompt_len, B: int, device) -> torch.Tensor:
    """Per-lane prompt lengths as an int32 [B] tensor. An int is written by
    a fill on the device: a host-to-device copy would wait for the card."""
    if isinstance(prompt_len, int):
        return torch.full((B,), prompt_len, dtype=torch.int32, device=device)
    p = torch.as_tensor(prompt_len, dtype=torch.int32, device=device).reshape(-1)
    return p.expand(B)


def _chunked_prefill(q, k, v, prompt_len, need_summary, obs_len, chunk_size):
    y, cum, obs = chunked_prefill_partial(
        q, k, v, prompt_len, need_summary=need_summary, obs_len=obs_len,
        chunk_size=chunk_size,
    )
    if not need_summary:
        return y, None
    plen = _plen(prompt_len, q.shape[0], q.device)
    return y, finalize_summary(cum, obs, plen, k.shape[2], obs_len)


def finalize_summary(cum, obs, plen, P: int, obs_len: int) -> AttnSummary:
    """Raw per-key sums over (valid / last-obs_len) queries -> per-key
    means."""
    key_pos = torch.arange(P, device=cum.device)
    obs_count = plen.clamp(max=obs_len).clamp_min(1).float()  # [B]
    denom = (plen[:, None] - key_pos[None, :]).clamp_min(1).float()  # [B, P]
    return {
        "obs_mean": obs / obs_count[:, None, None],
        "cum_mean": cum / denom[:, None, :],
    }


def chunked_prefill_partial(q, k, v, prompt_len, q_offset=0, need_summary=False,
                            obs_len=16, chunk_size=256, window=0):
    """Chunked causal attention for a query block at global position
    ``q_offset`` against the full key/value sequence (with ``window`` > 0,
    only the keys j with ``i - window < j <= i`` for the row at i).

    Returns (y [B, H, Pq, D], cum [B, KVH, P], obs [B, KVH, P]): y from
    bf16 operands with f32 scores and softmax and the normalized
    probabilities cast to bf16 before P.V; cum/obs the raw attention-mass
    sums over this block's valid / observation-window queries."""
    B, H, Pq, D = q.shape
    KVH, P = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    chunk = min(chunk_size, Pq)
    dev = q.device
    qg = q.reshape(B, KVH, G, Pq, D).to(torch.bfloat16)
    kf = k.to(torch.bfloat16).float()
    vf = v.to(torch.bfloat16).float()
    plen = _plen(prompt_len, B, dev)
    key_pos = torch.arange(P, device=dev)
    cum = torch.zeros((B, KVH, P), dtype=torch.float32, device=dev)
    obs = torch.zeros_like(cum)
    ys = []
    for c0 in range(0, Pq, chunk):
        qc = qg[:, :, :, c0 : c0 + chunk].float()
        n = qc.shape[3]
        q_pos = q_offset + c0 + torch.arange(n, device=dev)
        scores = torch.einsum("bkgld,bksd->bkgls", qc, kf) * scale
        causal = key_pos[None, :] <= q_pos[:, None]  # [n, P]
        if window:
            causal = causal & (key_pos[None, :] > q_pos[:, None] - window)
        scores = scores.masked_fill(~causal[None, None, None], NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        y_c = torch.einsum(
            "bkgls,bksd->bkgld", probs.to(torch.bfloat16).float(), vf
        ).to(torch.bfloat16)
        ys.append(y_c)
        if need_summary:
            pooled = probs.mean(dim=2)  # [B, KVH, n, P]
            q_valid = (q_pos[None, :] < plen[:, None]).float()  # [B, n]
            cum += torch.einsum("bkcs,bc->bks", pooled, q_valid)
            in_obs = (
                (q_pos[None, :] >= plen[:, None] - obs_len)
                & (q_pos[None, :] < plen[:, None])
            ).float()
            obs += torch.einsum("bkcs,bc->bks", pooled, in_obs)
    y = torch.cat(ys, dim=3).reshape(B, H, Pq, D).to(q.dtype)
    return y, cum, obs
