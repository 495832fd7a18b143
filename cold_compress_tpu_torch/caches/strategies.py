"""Built-in cache strategies of the port (``full``); the others of
``cold_compress_tpu/caches/strategies.py`` are later work."""

from __future__ import annotations

import torch

from .base import CacheStrategy


class FullCache(CacheStrategy):
    """Append-only cache sized to the full sequence."""

    name = "full"

    @classmethod
    def eviction_idx(cls, spec, state, input_pos) -> torch.Tensor:
        # First unfilled slot: argmin over pos (-1 slots first; ties pick the
        # lowest index, as jnp.argmin and torch.argmin both do).
        return state.pos.argmin(dim=-1).to(torch.int32)
