"""Cache statistics of a finished run, and their printing.

Port of ``cold_compress_tpu/runtime/stats.py``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict

from ..caches import cache_memory_gb, compression_ratio


def get_cache_stats(caches, prompt_len: int, gen_len: int) -> Dict[str, Any]:
    """Per layer i: ``compression_ratio_<i>`` (quantization-aware, over the
    final sequence; a ``debug_*`` cache reports its shadow's, since the
    outer cache keeps everything), ``attention_loss_<i>`` (the mean
    recorded loss of a ``debug_*`` cache) and ``attention_loss@<k>_<i>``
    (its running mean over the first k steps, every 500 steps), and
    ``avg_strategy_idx_<i>`` (a hybrid cache's mean policy index); the
    average of each over the layers (``<key>_avg``) and the caches' total
    ``cache_memory_gb``, shadows included."""
    stats: Dict[str, Any] = {}
    avgs = defaultdict(list)
    final_seq_len = prompt_len + gen_len
    for layer_idx, cache in enumerate(caches):
        extra = cache.extra
        layer_stats = {
            "compression_ratio": float(compression_ratio(extra.get("shadow", cache),
                                                         final_seq_len)),
        }
        if "attention_losses" in extra:
            ctr = int(extra["attention_loss_ctr"])
            if ctr > 0:
                losses = extra["attention_losses"][:ctr].cpu().numpy()
                layer_stats["attention_loss"] = float(losses.mean())
                for k in range(500, ctr, 500):
                    layer_stats[f"attention_loss@{k}"] = float(losses[:k].mean())
        if "strategy_idx" in extra:
            layer_stats["avg_strategy_idx"] = float(extra["strategy_idx"].cpu().numpy().mean())
        for key, val in layer_stats.items():
            stats[f"{key}_{layer_idx}"] = val
            avgs[key].append(val)
    for key, vals in avgs.items():
        stats[f"{key}_avg"] = sum(vals) / len(vals)
    stats["cache_memory_gb"] = sum(cache_memory_gb(c) for c in caches)
    return stats


def snake_to_capitalized(s: str) -> str:
    return " ".join(word.capitalize() for word in s.split("_"))


def print_stats(stats_dict: Dict[str, Any]) -> None:
    """Print run-wide values one per line (two decimals), then each per-layer
    key (``<name>_<layer>``) as one ``By Layer`` line."""
    layered: Dict[str, list] = {}
    flat: Dict[str, Any] = {}
    for key, value in stats_dict.items():
        parts = key.rsplit("_", 1)
        if len(parts) == 2 and parts[1].isdigit():
            layered.setdefault(snake_to_capitalized(parts[0]), []).append((int(parts[1]), value))
        else:
            flat[snake_to_capitalized(key)] = value
    for key, value in flat.items():
        try:
            print(f"{key}: {value:.02f}")
        except (TypeError, ValueError):
            print(f"{key}: {value}")
    for stat in sorted(layered):
        layers = ", ".join(f"{i}={v:.02f}" for i, v in sorted(layered[stat]))
        print(f"{stat} By Layer: {layers}")
