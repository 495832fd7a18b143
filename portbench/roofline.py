"""The yardstick: the work an operation needs, and the least time one card
could take for it.

Work is counted at the precisions the configuration states, whatever kernel
implements it: each input byte once (packed int4 weights with their bf16
scales and zeros, kv8 cache rows with their f32 scales and zeros, bf16
activations), each output byte once, a product as 2 M N K, causal attention
as QK and PV over the causal pairs once. Each product runs at the card's
fastest published rate for its stored operands: int8 for int4 or int8
weights and for a quantized cache, bf16 for bf16 operands. The least time is
the larger of the operations' time and the bytes' time. Each architecture
module (``arch/``) counts its own operations with these.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

#: NVIDIA H100 SXM, dense, at 700 W (NVIDIA's data sheet).
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


@dataclass
class Work:
    """Operations at each rate and bytes; ``+`` adds, ``*`` scales."""

    int8_ops: float = 0.0
    bf16_flops: float = 0.0
    nbytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.int8_ops + o.int8_ops, self.bf16_flops + o.bf16_flops,
                    self.nbytes + o.nbytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.int8_ops * k, self.bf16_flops * k, self.nbytes * k)

    def seconds(self) -> float:
        """The least time: the larger of the operations' and the bytes'."""
        ops = self.int8_ops / PEAK_INT8_OPS + self.bf16_flops / PEAK_BF16_FLOPS
        return max(ops, self.nbytes / PEAK_BYTES)


def int4_bytes(IN: int, OUT: int, gs: int) -> float:
    return IN * OUT / 2 + 2 * 2 * (IN // gs) * OUT


def gemv(d, L: int, IN: int, OUT: int) -> Work:
    """An int4 projection of L rows (W4A8): bf16 x in, bf16 y out."""
    return Work(int8_ops=2.0 * L * IN * OUT,
                nbytes=int4_bytes(IN, OUT, d.group_size) + 2.0 * L * (IN + OUT))


def causal_pairs(lengths: Sequence[int]) -> float:
    return float(sum(n * (n + 1) // 2 for n in lengths))
