"""The yardstick: the work an operation needs, and the least time one card
could take for it.

Work is counted at the precisions the configuration states, whatever kernel
implements it: each input byte once (packed int4 weights with their bf16
scales and zeros, kv8 cache rows with their f32 scales and zeros, bf16
activations), each output byte once, a product as 2 M N K, causal attention
as QK and PV over the causal pairs once. Each product runs at the card's
fastest published rate for its stored operands: int8 for int4 or int8
weights and for a quantized cache, bf16 for bf16 operands. The least time is
the larger of the operations' time and the bytes' time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from .spec import Dims

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


def layer_linears(d: Dims):
    """(in, out) of one layer's projections: qkv, o, gate|up, down."""
    q, kv = d.n_head * d.head_dim, d.n_kv_head * d.head_dim
    return [(d.dim, q + 2 * kv), (q, d.dim), (d.dim, 2 * d.intermediate), (d.intermediate, d.dim)]


def int4_bytes(IN: int, OUT: int, gs: int) -> float:
    return IN * OUT / 2 + 2 * 2 * (IN // gs) * OUT


def gemv(d: Dims, L: int, IN: int, OUT: int) -> Work:
    """An int4 projection of L rows (W4A8): bf16 x in, bf16 y out."""
    return Work(int8_ops=2.0 * L * IN * OUT,
                nbytes=int4_bytes(IN, OUT, d.group_size) + 2.0 * L * (IN + OUT))


def decode_gemvs(d: Dims, L: int) -> Work:
    """Every int4 projection of one decode step over L lanes, head included."""
    w = Work()
    for IN, OUT in layer_linears(d):
        w = w + gemv(d, L, IN, OUT) * d.n_layer
    return w + gemv(d, L, d.dim, d.vocab)


def decode_attention(d: Dims, B: int, C: int, bits: int = 8) -> Work:
    """One layer's decode attention over a cache of C slots a lane: QK and
    PV at int8, K and V as stored plus an f32 scale and zero each and a
    mask byte per slot, q and y in bf16, the pooled probabilities out in
    f32."""
    slot = d.n_kv_head * C * (2 * d.head_dim * bits / 8 + 4 * 4 + 1 + 4)
    act = 2 * 2 * d.n_head * d.head_dim
    return Work(int8_ops=2.0 * 2 * d.n_head * C * d.head_dim * B, nbytes=B * (slot + act))


def decode_step(d: Dims, B: int, C: int, bits: int = 8) -> Work:
    """A whole decode step: the projections and every layer's attention."""
    return decode_gemvs(d, B) + decode_attention(d, B, C, bits) * d.n_layer


def causal_pairs(lengths: Sequence[int]) -> float:
    return float(sum(n * (n + 1) // 2 for n in lengths))


def prefill_attention(d: Dims, lengths: Sequence[int]) -> Work:
    """One layer's causal prefill attention with SnapKV's summaries, over
    prompts of these lengths: QK and PV over the causal pairs in bf16; q,
    k, v in and y out in bf16, the two per-key summaries out in f32."""
    n = float(sum(lengths))
    io = n * (2 * (2 * d.n_head + 2 * d.n_kv_head) * d.head_dim + 2 * 4 * d.n_kv_head)
    return Work(bf16_flops=2.0 * 2 * d.head_dim * d.n_head * causal_pairs(lengths), nbytes=io)


def prefill(d: Dims, lengths: Sequence[int]) -> Work:
    """A whole prefill: every projection of every prompt token in bf16 over
    the dequantized weights (each int4 weight byte read once), causal
    attention, the head over each prompt's last row (W4A8)."""
    n = float(sum(lengths))
    w = Work()
    for IN, OUT in layer_linears(d):
        w = w + Work(bf16_flops=2.0 * n * IN * OUT, nbytes=int4_bytes(IN, OUT, d.group_size)
                     + 2.0 * n * (IN + OUT)) * d.n_layer
    w = w + prefill_attention(d, lengths) * d.n_layer
    return w + gemv(d, len(lengths), d.dim, d.vocab)
