"""Built-in cache strategies: full, recent_global, random, l2, keep_it_odd.

Port of ``cold_compress_tpu/caches/strategies.py``: each evicts the slots
its JAX counterpart evicts. ``random`` draws the reference's scores
bit for bit (``utils/prng.py``).
"""

from __future__ import annotations

import torch

from ..utils import prng
from .base import POS_INF, CacheStrategy, scatter_scalar


class FullCache(CacheStrategy):
    """Append-only cache sized to the full sequence."""

    name = "full"

    @classmethod
    def eviction_idx(cls, spec, state, input_pos) -> torch.Tensor:
        # First unfilled slot: argmin over pos (-1 slots first; ties pick the
        # lowest index, as jnp.argmin and torch.argmin both do).
        return state.pos.argmin(dim=-1).to(torch.int32)


class RecentGlobalCache(CacheStrategy):
    """Sliding window plus attention sinks: evicts the oldest token past
    the global-token prefix."""

    name = "recent_global"

    @classmethod
    def eviction_idx(cls, spec, state, input_pos) -> torch.Tensor:
        g = spec.global_tokens
        return (state.pos[:, :, g:].argmin(dim=-1) + g).to(torch.int32)


class RandomCache(CacheStrategy):
    """Random eviction outside the recent window. The scores are
    ``uniform(fold_in(PRNGKey(1234), rng_counter), (1, 1, C))``, the same
    for every head, with a step counter kept in the state."""

    name = "random"

    @staticmethod
    def init_extra(spec, B, H, D, device=None):
        return {"rng_counter": torch.zeros((), dtype=torch.int32, device=device)}

    @staticmethod
    def token_importances(spec, state, input_pos):
        counter = state.extra["rng_counter"]
        key = prng.fold_in(prng.prng_key(1234, device=counter.device), counter)
        scores = prng.uniform(key, (1, 1, state.pos.shape[-1]))
        return torch.where(state.pos >= input_pos - spec.recent_window, POS_INF, scores)

    @classmethod
    def eviction_idx(cls, spec, state, input_pos) -> torch.Tensor:
        idx = super().eviction_idx(spec, state, input_pos)
        state.extra["rng_counter"] += 1
        return idx


class L2Cache(CacheStrategy):
    """Evicts the key with the highest L2 norm (low-norm keys matter most,
    arXiv:2406.11430); the recent window is protected. The norms live in
    ``extra["key_norm"]``, filled by the insert hooks."""

    name = "l2"

    @staticmethod
    def init_extra(spec, B, H, D, device=None):
        return {
            "key_norm": torch.zeros((B, H, spec.max_cache_length), dtype=torch.float32,
                                    device=device)
        }

    @staticmethod
    def token_importances(spec, state, input_pos):
        key_norm = state.extra["key_norm"]
        scores = key_norm.max() - key_norm
        return torch.where(state.pos >= input_pos - spec.recent_window, POS_INF, scores)

    @classmethod
    def on_decode_fill(cls, spec, state, idx, input_pos, k_row, v_row):
        scatter_scalar(state.extra["key_norm"], idx, key_norms(k_row))
        return state

    @classmethod
    def on_prefill_fill(cls, spec, state, input_pos, k, v, valid):
        P = k.shape[2]
        state.extra["key_norm"][:, :, :P] = torch.where(valid, key_norms(k), 0.0)
        return state


def key_norms(k: torch.Tensor) -> torch.Tensor:
    """L2 norm of each key row in f32 ([..., D] -> [...])."""
    return torch.linalg.vector_norm(k.float(), dim=-1)


class KeepItOddCache(CacheStrategy):
    """Toy strategy: evicts even positions first, never the recent window."""

    name = "keep_it_odd"

    @staticmethod
    def token_importances(spec, state, input_pos):
        scores = (state.pos % 2 == 1).float()
        return torch.where(state.pos >= input_pos - spec.recent_window, POS_INF, scores)
