"""Cache strategy registry of the port: ``full``, ``random``,
``recent_global``, ``l2``, ``keep_it_odd`` and ``heavy_hitter``."""

from .base import (
    CacheSpec,
    CacheState,
    CacheStrategy,
    cache_memory_gb,
    compression_ratio,
    decode_update,
    init_state,
    materialize_kv,
    prefill_update,
    reset_state,
    strategy_needs_attn,
)
from .heavy_hitter import HeavyHitterCache
from .prompt_compression import PROMPT_COMPRESSORS, compress_prompt, get_prompt_compressor
from .strategies import FullCache, KeepItOddCache, L2Cache, RandomCache, RecentGlobalCache

CACHE_STRATEGIES = {
    c.name: c
    for c in [
        FullCache, RandomCache, RecentGlobalCache, L2Cache, KeepItOddCache, HeavyHitterCache,
    ]
}


def register_strategy(cls):
    CACHE_STRATEGIES[cls.name] = cls
    return cls


def get_cache_strategy(name: str):
    """Resolve a strategy class by name. The JAX package's ``debug_<name>``
    analysis wrapper and ``hybrid`` (FastGen) are not ported yet."""
    if name.startswith("debug_") or name == "hybrid":
        raise ValueError(f"Cache strategy {name!r} is not ported yet")
    if name not in CACHE_STRATEGIES:
        raise ValueError(f"Invalid cache strategy: {name}")
    return CACHE_STRATEGIES[name]


__all__ = [
    "CACHE_STRATEGIES", "CacheSpec", "CacheState", "CacheStrategy", "FullCache",
    "HeavyHitterCache", "KeepItOddCache", "L2Cache", "PROMPT_COMPRESSORS", "RandomCache",
    "RecentGlobalCache", "cache_memory_gb", "compress_prompt", "compression_ratio",
    "decode_update", "get_cache_strategy", "get_prompt_compressor", "init_state",
    "materialize_kv", "prefill_update", "register_strategy", "reset_state",
    "strategy_needs_attn",
]
