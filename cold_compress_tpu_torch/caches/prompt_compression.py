"""Prompt compression: prefill-time eviction when |prompt| > cache budget.

Port of ``cold_compress_tpu/caches/prompt_compression.py``: the ``full``
(pass-through), ``random``, ``recent_global``, ``l2``, ``keep_it_odd`` and
``heavy_hitter`` (SnapKV) compressors. Priorities are computed per head over the padded prompt, padded tokens get
the lowest priority, and the top ``C`` tokens are kept in their original
order.
"""

from __future__ import annotations

import torch

from ..utils import prng

NEG_INF = float(torch.finfo(torch.float32).min)
BIG = 1e9


class PromptCompressorBase:
    name = "abstract"
    needs_attn = False

    @staticmethod
    def token_importances(spec, input_pos, k, v, prompt_len, summary=None):
        """Priority [B, KVH or 1, P] (higher = keep)."""
        raise NotImplementedError


def _plen_b(prompt_len, device) -> torch.Tensor:
    """Per-lane prompt lengths as a [B or 1, 1, 1] int32 column."""
    return torch.as_tensor(prompt_len, dtype=torch.int32, device=device).reshape(-1, 1, 1)


def _recent_global_save_mask(spec, input_pos, prompt_len) -> torch.Tensor:
    """Tokens never dropped: the global prefix and the recent window, per
    lane. Returns bool [B or 1, 1, P]."""
    plen = _plen_b(prompt_len, input_pos.device)
    ip = input_pos[None, None, :]
    return (ip < spec.global_tokens) | (ip >= plen - spec.recent_window)


class PromptCompressorFull(PromptCompressorBase):
    """Pass-through."""

    name = "full"


class PromptCompressorRandom(PromptCompressorBase):
    """Keeps the global prefix and the recent window, and a random selection
    elsewhere: ``uniform(fold_in(PRNGKey(1234), sum(prompt_len)), (P,))``,
    the reference's draws bit for bit."""

    name = "random"

    @staticmethod
    def token_importances(spec, input_pos, k, v, prompt_len, summary=None):
        P = input_pos.shape[-1]
        dev = input_pos.device
        total = torch.as_tensor(prompt_len, dtype=torch.int64, device=dev).sum()
        noise = prng.uniform(prng.fold_in(prng.prng_key(1234, device=dev), total), (P,))
        save = _recent_global_save_mask(spec, input_pos, prompt_len)
        return torch.where(save, BIG, noise[None, None, :])


class PromptCompressorRecentGlobal(PromptCompressorBase):
    """Keeps the most recent tokens plus the global prefix."""

    name = "recent_global"

    @staticmethod
    def token_importances(spec, input_pos, k, v, prompt_len, summary=None):
        priority = torch.where(input_pos < spec.global_tokens, BIG, input_pos.float())
        return priority[None, None, :]


class PromptCompressorL2(PromptCompressorBase):
    """Keeps low-L2-norm keys, the global prefix and the recent window."""

    name = "l2"

    @staticmethod
    def token_importances(spec, input_pos, k, v, prompt_len, summary=None):
        priority = -torch.linalg.vector_norm(k.float(), dim=-1)
        save = _recent_global_save_mask(spec, input_pos, prompt_len)
        return torch.where(save, BIG, priority)


class PromptCompressorKeepItOdd(PromptCompressorBase):
    """Toy: prefers odd positions, keeps the global prefix and the recent
    window."""

    name = "keep_it_odd"

    @staticmethod
    def token_importances(spec, input_pos, k, v, prompt_len, summary=None):
        P = input_pos.shape[-1]
        priority = input_pos.float()
        priority = torch.where(input_pos % 2 == 0, priority - 2.0 * P, priority)
        save = _recent_global_save_mask(spec, input_pos, prompt_len)
        return torch.where(save, BIG, priority[None, None, :])


class PromptCompressorHeavyHitter(PromptCompressorBase):
    """SnapKV: score prompt tokens by pooled attention from an observation
    window of trailing queries (arXiv:2404.14469)."""

    name = "heavy_hitter"
    needs_attn = True
    kernel_size = 5
    observation_len = 16

    @classmethod
    def token_importances(cls, spec, input_pos, k, v, prompt_len, summary=None):
        if summary is None:
            raise ValueError("SnapKV needs the prefill attention summary")
        plen = _plen_b(prompt_len, input_pos.device)
        obs_len = plen.clamp(max=cls.observation_len)
        priority = _avg_pool_1d(summary["obs_mean"], cls.kernel_size)
        ip = input_pos[None, None, :]
        keep = ((ip >= plen - obs_len) & (ip < plen)) | (ip < spec.global_tokens)
        return torch.where(keep, BIG, priority)


def _avg_pool_1d(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Same-shape average pooling along the last axis with edge-corrected
    counts (AvgPool1d(count_include_pad=False)), computed by the reference's
    padded cumulative sum."""
    half = kernel // 2
    P = x.shape[-1]
    padded = torch.nn.functional.pad(x, (half, half))
    csum = torch.nn.functional.pad(torch.cumsum(padded, dim=-1), (1, 0))
    window_sum = csum[..., kernel : kernel + P] - csum[..., :P]
    idx = torch.arange(P, device=x.device)
    counts = (idx + half).clamp(max=P - 1) - (idx - half).clamp_min(0) + 1
    return window_sum / counts.to(x.dtype)


PROMPT_COMPRESSORS = {
    c.name: c
    for c in [
        PromptCompressorFull,
        PromptCompressorRandom,
        PromptCompressorRecentGlobal,
        PromptCompressorL2,
        PromptCompressorKeepItOdd,
        PromptCompressorHeavyHitter,
    ]
}


def get_prompt_compressor(strategy: str):
    if strategy not in PROMPT_COMPRESSORS:
        raise ValueError(f"Unknown prompt compression strategy: {strategy}")
    return PROMPT_COMPRESSORS[strategy]


def compress_prompt(compressor, spec, input_pos, k, v, valid, prompt_len, summary=None):
    """Score, select and gather the kept prompt tokens.

    Returns ``(keep_pos [B,KVH,C], k' [B,KVH,C,D], v', keep_valid [B,KVH,C],
    kept_attn [B,KVH,C] | None)`` with C = spec.max_cache_length.

    Top-C selection is a stable descending sort, so tied priorities keep the
    lower index first, as ``jax.lax.top_k`` does (``torch.topk`` makes no
    such promise on CUDA)."""
    B, KVH, P, D = k.shape
    C = spec.max_cache_length
    priority = compressor.token_importances(
        spec, input_pos, k, v, prompt_len, summary=summary
    )
    priority = priority.float().expand(B, KVH, P)
    priority = torch.where(valid[:, None, :], priority, NEG_INF)
    order = torch.sort(priority, dim=-1, descending=True, stable=True).indices
    keep_idx = order[..., :C].sort(dim=-1).values  # ascending original order
    keep_pos = input_pos[None, None, :].expand(B, KVH, P).gather(-1, keep_idx)
    keep_valid = valid[:, None, :].expand(B, KVH, P).gather(-1, keep_idx)
    gidx = keep_idx[..., None].expand(B, KVH, C, D)
    k_out = k.gather(2, gidx)
    v_out = v.gather(2, gidx)
    kept_attn = None
    if summary is not None:
        kept_attn = summary["cum_mean"].gather(-1, keep_idx)
        kept_attn = torch.where(keep_valid, kept_attn, 0.0)
    return keep_pos, k_out, v_out, keep_valid, kept_attn
