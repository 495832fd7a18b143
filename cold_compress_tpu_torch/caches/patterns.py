"""Per-layer cache lengths and strategies (port of
``cold_compress_tpu/caches/patterns.py``): fraction-to-length
normalisation, ``tile``/``repeat`` extension and the PyramidKV-style
``pyramid``/``funnel`` ramps."""

from __future__ import annotations

from typing import List, Optional, Sequence

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


def apply_pyramid_pattern(max_cache_length: int, max_seq_length: int, n_layer: int,
                          decreasing: bool = True, min_cache_length: int = 256) -> List[int]:
    """PyramidKV (arXiv:2406.02069) linear ramp with beta = 14 and the
    minimum length redistributed. ``decreasing`` gives the pyramid (large
    lower layers), otherwise the funnel."""
    beta = 14
    min_allowable = min(min_cache_length, max_cache_length)
    total_len = max_cache_length * n_layer
    lo = total_len / (n_layer * beta)
    hi = 2 * total_len / n_layer
    diff = (hi - lo) / n_layer
    lens = [lo] + [lo + diff * i for i in range(1, n_layer - 1)] + [hi]
    lens = [normalize_cache_length(int(n), max_seq_length) for n in lens]

    overflow = 0
    num_overflow = 0
    for i, n in enumerate(lens):
        if n < min_allowable:
            overflow += min_allowable - n
            lens[i] = min_allowable
            num_overflow += 1
    if num_overflow < len(lens):
        decr = overflow // (len(lens) - num_overflow)
        for i, n in enumerate(lens):
            if n > min_allowable:
                lens[i] = max(min_allowable, n - decr)

    if decreasing:
        lens = lens[::-1]
        if not lens[-1] < lens[0]:
            raise ValueError("Cache lengths should be decreasing.")
    elif not lens[0] < lens[-1]:
        raise ValueError("Cache lengths should be increasing.")
    return lens


def apply_pattern(pattern: Sequence, out_size: int, extension_strategy: str = "tile",
                  max_seq_length: Optional[int] = None):
    """Extend a per-layer pattern across all layers: ``tile`` (each item
    repeated in place), ``repeat`` (the whole pattern repeated), or a
    ``pyramid``/``funnel`` ramp from a single length."""
    if extension_strategy not in ("tile", "repeat", "pyramid", "funnel"):
        raise ValueError(f"Unknown cache pattern {extension_strategy!r}")
    if out_size % len(pattern):
        raise ValueError(f"{len(pattern)} must divide the number of layers ({out_size}).")
    factor = out_size // len(pattern)
    if extension_strategy in ("pyramid", "funnel"):
        if len(pattern) != 1:
            raise ValueError("Funnel and pyramid patterns must have a single element.")
        return apply_pyramid_pattern(pattern[0], max_seq_length, out_size,
                                     decreasing=extension_strategy == "pyramid")
    if extension_strategy == "tile":
        return [item for item in pattern for _ in range(factor)]
    return list(pattern) * factor
