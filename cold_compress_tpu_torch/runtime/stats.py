"""Cache statistics of a finished run.

Port of ``cold_compress_tpu/runtime/stats.py::get_cache_stats`` without
the keys of the caches that are not ported yet (``debug_*`` attention
losses, the hybrid strategy index).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict

from ..caches import cache_memory_gb, compression_ratio


def get_cache_stats(caches, prompt_len: int, gen_len: int) -> Dict[str, Any]:
    """Per-layer ``compression_ratio_<i>`` (quantization-aware, over the
    final sequence), their average ``compression_ratio_avg``, and the
    caches' total ``cache_memory_gb``. Reads the counts once from the
    device."""
    stats: Dict[str, Any] = {}
    avgs = defaultdict(list)
    final_seq_len = prompt_len + gen_len
    for layer_idx, cache in enumerate(caches):
        ratio = float(compression_ratio(cache, final_seq_len))
        stats[f"compression_ratio_{layer_idx}"] = ratio
        avgs["compression_ratio"].append(ratio)
    for key, vals in avgs.items():
        stats[f"{key}_avg"] = sum(vals) / len(vals)
    stats["cache_memory_gb"] = sum(cache_memory_gb(c) for c in caches)
    return stats
