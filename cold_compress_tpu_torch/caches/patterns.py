"""Per-layer cache length normalisation (port of
``cold_compress_tpu/caches/patterns.py``; only the ``tile`` pattern so
far)."""

from __future__ import annotations

from typing import Sequence

from ..models.config import find_multiple


def normalize_cache_length(max_cache_length: float, max_seq_length: int,
                           multiple_of: int = 8) -> int:
    """Fraction-or-absolute -> absolute length, rounded up to a multiple of 8
    and clamped to ``max_seq_length``."""
    if 0 < max_cache_length <= 1:
        max_cache_length = round(max_seq_length * max_cache_length)
    else:
        if int(max_cache_length) != max_cache_length:
            raise ValueError(f"cache length {max_cache_length} is neither a fraction nor whole")
        max_cache_length = min(int(max_cache_length), max_seq_length)
    return min(find_multiple(int(max_cache_length), multiple_of), max_seq_length)


def apply_pattern(pattern: Sequence, out_size: int, extension_strategy: str = "tile"):
    """Extend a per-layer pattern across all layers (``tile`` or
    ``repeat``)."""
    if extension_strategy not in ("tile", "repeat"):
        raise ValueError(f"cache pattern {extension_strategy!r} is not ported yet")
    if out_size % len(pattern):
        raise ValueError(f"{len(pattern)} must divide the number of layers ({out_size}).")
    factor = out_size // len(pattern)
    if extension_strategy == "tile":
        return [item for item in pattern for _ in range(factor)]
    return list(pattern) * factor
