"""Ops of the port: linear projections, attention, and the CUDA kernels'
wrappers with their plain versions.

Kernel modules import nothing CUDA-specific at import time; each kernel is
built at its first launch (``_build.py``).
"""

from typing import Dict

from . import decode_attn, evict, prefill_attn, qmm

_COUNTS = (qmm.LAUNCHES, decode_attn.LAUNCHES, evict.LAUNCHES, prefill_attn.LAUNCHES)


def kernel_launches() -> Dict[str, int]:
    """Launch counts of every CUDA kernel wrapper, by name."""
    return {key: n for counts in _COUNTS for key, n in counts.items()}


def reset_kernel_launches() -> None:
    for counts in _COUNTS:
        for key in counts:
            counts[key] = 0


def add_kernel_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` (launches by name, possibly negative) to the counts: a
    replayed CUDA graph adds the launches its capture recorded."""
    for key, n in delta.items():
        counts = next(c for c in _COUNTS if key in c)
        counts[key] += n
