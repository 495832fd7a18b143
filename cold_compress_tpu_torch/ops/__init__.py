"""Ops of the port: linear projections, attention, and the CUDA kernels'
wrappers with their plain versions.

Kernel modules import nothing CUDA-specific at import time; each kernel is
built at its first launch (``_build.py``).
"""

from typing import Dict

from . import decode_attn, prefill_attn, qmm


def kernel_launches() -> Dict[str, int]:
    """Launch counts of every CUDA kernel wrapper, by name."""
    return {**qmm.LAUNCHES, **decode_attn.LAUNCHES, **prefill_attn.LAUNCHES}


def reset_kernel_launches() -> None:
    for counts in (qmm.LAUNCHES, decode_attn.LAUNCHES, prefill_attn.LAUNCHES):
        for key in counts:
            counts[key] = 0
