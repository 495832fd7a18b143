"""Rotary position embeddings with Llama-3.1 frequency scaling.

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
    float64 numpy exactly as the reference does, then rounded once."""
    freqs = 1.0 / (base ** (np.arange(0, n_elem, 2)[: n_elem // 2] / n_elem))
    if rope_scaling is not None:
        if rope_scaling.rope_type != "llama3":
            raise ValueError("Only Llama 3.1 scaling is supported")
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
    table = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


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
