"""Rotary position embeddings with Llama-3.1 or YaRN frequency scaling.

Port of ``cold_compress_tpu/models/rope.py``: interleaved-pair rotation
(pairs (2i, 2i+1)), not rotate-half.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .config import RopeScaling


def precompute_freqs_cis(
    seq_len: int,
    n_elem: int,
    base: float = 10000.0,
    rope_scaling: Optional[RopeScaling] = None,
    device=None,
) -> torch.Tensor:
    """Return a [seq_len, n_elem//2, 2] (cos, sin) table in f32, computed in
    float64 numpy exactly as the reference does, then rounded once. YaRN's
    table holds cos and sin times its attention factor."""
    freqs = 1.0 / (base ** (np.arange(0, n_elem, 2)[: n_elem // 2] / n_elem))
    mscale = 1.0
    if rope_scaling is not None and rope_scaling.rope_type == "yarn":
        freqs, mscale = yarn_freqs(freqs, n_elem, base, rope_scaling)
    elif rope_scaling is not None:
        if rope_scaling.rope_type != "llama3":
            raise ValueError(f"rope scaling {rope_scaling.rope_type!r} (llama3 or yarn)")
        low_wl = (
            rope_scaling.original_max_position_embeddings
            / rope_scaling.low_freq_factor
        )
        high_wl = (
            rope_scaling.original_max_position_embeddings
            / rope_scaling.high_freq_factor
        )
        scaled = []
        for f in freqs:
            wl = 2 * math.pi / f
            if wl < high_wl:
                scaled.append(f)
            elif wl > low_wl:
                scaled.append(f / rope_scaling.factor)
            else:
                smooth = (
                    rope_scaling.original_max_position_embeddings / wl
                    - rope_scaling.low_freq_factor
                ) / (rope_scaling.high_freq_factor - rope_scaling.low_freq_factor)
                scaled.append((1 - smooth) * f / rope_scaling.factor + smooth * f)
        freqs = np.array(scaled)
    angles = np.outer(np.arange(seq_len), freqs)
    table = np.stack([np.cos(angles), np.sin(angles)], axis=-1) * mscale
    return torch.from_numpy(table.astype(np.float32)).to(device)


def yarn_freqs(freqs: np.ndarray, n_elem: int, base: float, scaling: RopeScaling):
    """YaRN's frequencies and attention factor (``transformers``'
    ``_compute_yarn_parameters``, in float64): the correction dims
    ``n ln(L / (beta 2 pi)) / (2 ln base)`` for ``beta_fast`` (floored) and
    ``beta_slow`` (ceiled), clamped to [0, n - 1]; a linear ramp r between
    them over the n / 2 frequencies; ``inv = (inv / factor) r + inv (1 - r)``;
    the factor ``attention_factor`` or ``0.1 ln(factor) + 1``."""
    L = scaling.original_max_position_embeddings

    def dim(rotations: float) -> float:
        return n_elem * math.log(L / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(dim(scaling.beta_fast)), 0)
    high = min(math.ceil(dim(scaling.beta_slow)), n_elem - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(n_elem // 2, dtype=np.float64) - low) / (high - low), 0.0, 1.0)
    inv = freqs / scaling.factor * ramp + freqs * (1.0 - ramp)
    mscale = scaling.attention_factor
    if mscale is None:
        mscale = 0.1 * math.log(scaling.factor) + 1.0 if scaling.factor > 1 else 1.0
    return inv, mscale


def apply_rotary_emb(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x: [B, L, H, D]; freqs: [L, D//2, 2] shared across the batch, or
    [B, L, D//2, 2] per lane. Rotation in f32, result in x's dtype."""
    B, L, H, D = x.shape
    xf = x.float().reshape(B, L, H, D // 2, 2)
    if freqs.dim() == 4:
        cos = freqs[:, :, None, :, 0]
        sin = freqs[:, :, None, :, 1]
    else:
        cos = freqs[None, :, None, :, 0]
        sin = freqs[None, :, None, :, 1]
    x0 = xf[..., 0]
    x1 = xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.reshape(B, L, H, D).to(x.dtype)


class QKVRows:
    """A fused q|k|v projection ``y`` [B, L, (H + 2 KVH) hd] and its rope
    rows ``freqs``, rotated where read. ``kv()``: k rotated and v
    [B, KVH, L, hd]. ``q()``: q rotated [B, H, L, hd], or what a decode
    insert that rotates q in its own kernel left in ``q_rotated``
    (``caches/base.py::CacheStrategy.rotate_insert``)."""

    def __init__(self, y: torch.Tensor, freqs: torch.Tensor, n_head: int, n_kv_head: int,
                 head_dim: int):
        self.y, self.freqs = y, freqs
        self.n_head, self.n_kv_head, self.head_dim = n_head, n_kv_head, head_dim
        self.q_rotated = None

    def _heads(self, first: int, n: int) -> torch.Tensor:
        B, L, _ = self.y.shape
        hd = self.head_dim
        return self.y[..., first * hd : (first + n) * hd].reshape(B, L, n, hd)

    def q(self) -> torch.Tensor:
        if self.q_rotated is not None:
            return self.q_rotated
        return apply_rotary_emb(self._heads(0, self.n_head), self.freqs).transpose(1, 2)

    def kv(self):
        H, KVH = self.n_head, self.n_kv_head
        k = apply_rotary_emb(self._heads(H, KVH), self.freqs)
        return k.transpose(1, 2), self._heads(H + KVH, KVH).transpose(1, 2)


def split_rotate_qkv(y: torch.Tensor, freqs: torch.Tensor, n_head: int, n_kv_head: int,
                     head_dim: int):
    """A fused q|k|v projection y [B, L, (H + 2 KVH) hd] split into heads,
    q and k rotated: q [B, H, L, hd], k/v [B, KVH, L, hd]."""
    rows = QKVRows(y, freqs, n_head, n_kv_head, head_dim)
    q = rows.q()
    return (q, *rows.kv())
