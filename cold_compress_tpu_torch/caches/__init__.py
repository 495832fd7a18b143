"""Cache strategy registry of the port (``full`` and ``heavy_hitter``)."""

from .base import (
    CacheSpec,
    CacheState,
    CacheStrategy,
    cache_memory_gb,
    decode_update,
    init_state,
    materialize_kv,
    prefill_update,
    reset_state,
    strategy_needs_attn,
)
from .heavy_hitter import HeavyHitterCache
from .prompt_compression import PROMPT_COMPRESSORS, compress_prompt, get_prompt_compressor
from .strategies import FullCache

CACHE_STRATEGIES = {c.name: c for c in [FullCache, HeavyHitterCache]}


def get_cache_strategy(name: str):
    if name not in CACHE_STRATEGIES:
        raise ValueError(f"Invalid cache strategy: {name}")
    return CACHE_STRATEGIES[name]


__all__ = [
    "CACHE_STRATEGIES", "CacheSpec", "CacheState", "CacheStrategy", "FullCache",
    "HeavyHitterCache", "PROMPT_COMPRESSORS", "cache_memory_gb", "compress_prompt",
    "decode_update", "get_cache_strategy", "get_prompt_compressor", "init_state",
    "materialize_kv", "prefill_update", "reset_state", "strategy_needs_attn",
]
