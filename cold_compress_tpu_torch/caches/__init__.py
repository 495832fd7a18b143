"""Cache strategy registry of the port: ``full``, ``random``,
``recent_global``, ``l2``, ``keep_it_odd``, ``heavy_hitter``, the FastGen
``hybrid``, the ``debug_<name>`` attention-loss analysis wrappers, and
``window``, the ring of a sliding-window layer (``caches/window.py``),
which ``build_cache_specs`` gives such layers whatever policy is asked."""

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
    """Resolve a strategy class by name; ``debug_<name>`` resolves to the
    attention-loss analysis wrapper of ``<name>``."""
    if name.startswith("debug_"):
        from .analysis import make_analysis_strategy

        return make_analysis_strategy(name[len("debug_"):])
    if name == "hybrid":
        from .hybrid import HybridCache

        return HybridCache
    if name == "window":
        from .window import WindowCache

        return WindowCache
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
