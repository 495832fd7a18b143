"""The dense decoder: grouped-query attention over the full causal context
with one rope table, a SwiGLU FFN in every layer, q/k/v biases where the
configuration has them (Llama, Mistral, Qwen2). The interface every
architecture module gives is in ``arch/__init__.py``.

Weights: the port's unfused parameter tree (``layers[i]["attn"]["wq"]``
...), every projection and the head int4 (``weights.int4_leaves``), then
from the same generator the embedding ``0.02 N(0, 1)``, the norms
``1 + 0.1 N(0, 1)`` and the biases ``0.02 N(0, 1)``, all bf16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from ..reference.model import Reference  # noqa: F401  (the interface's reference)
from ..roofline import Work, causal_pairs, gemv, int4_bytes
from ..weights import int4_leaves


@dataclass(frozen=True)
class Dims:
    """The sizes the benchmark's own code needs (weights, reference,
    roofline), read from the published config keys."""

    n_layer: int
    dim: int
    n_head: int
    n_kv_head: int
    head_dim: int
    intermediate: int
    vocab: int
    rope_theta: float
    norm_eps: float
    qkv_bias: bool
    group_size: int

    @classmethod
    def from_config(cls, doc: dict) -> "Dims":
        n_head = int(doc["num_attention_heads"])
        return cls(
            n_layer=int(doc["num_hidden_layers"]),
            dim=int(doc["hidden_size"]),
            n_head=n_head,
            n_kv_head=int(doc["num_key_value_heads"]),
            head_dim=int(doc.get("head_dim") or doc["hidden_size"] // n_head),
            intermediate=int(doc["intermediate_size"]),
            vocab=int(doc["vocab_size"]),
            rope_theta=float(doc["rope_theta"]),
            norm_eps=float(doc["rms_norm_eps"]),
            qkv_bias=bool(doc["port"]["qkv_bias"]),
            group_size=int(doc["port"]["weights"]["group_size"]),
        )


def dims(doc: dict) -> Dims:
    return Dims.from_config(doc)


def checked_layer(d: Dims) -> int:
    """Every layer holds the same cache; the first depends on no earlier
    layer, so two sound programs agree there to the last place."""
    return 0


def port_config(cell):
    """The port's ``ModelConfig`` for the cell: the registry entry with the
    configuration file's fields set, checked against the published sizes."""
    from cold_compress_tpu_torch.models.config import ModelConfig

    port = cell.config["port"]
    cfg = ModelConfig.from_name(port["registry_name"]).replace(**port["set"])
    d = cell.dims
    want = {"n_layer": d.n_layer, "dim": d.dim, "n_head": d.n_head, "n_kv_head": d.n_kv_head,
            "head_dim": d.head_dim, "intermediate_size": d.intermediate, "vocab_size": d.vocab,
            "rope_base": d.rope_theta, "norm_eps": d.norm_eps, "attention_bias": d.qkv_bias}
    wrong = {k: (getattr(cfg, k), v) for k, v in want.items() if getattr(cfg, k) != v}
    if wrong:
        raise ValueError(f"registry entry {port['registry_name']} differs from the "
                         f"configuration file: {wrong}")
    return cfg


def cache_kwargs(doc: dict, cfg) -> dict:
    """One cache for every layer."""
    return {"cache_strategy": [doc["strategy"]], "max_cache_length": [doc["max_cache_length"]],
            "prompt_compression_strategy": [doc["prompt_compression"]],
            "global_tokens": doc["global_tokens"], "recent_window": doc["recent_window"],
            "cache_bits": doc["bits"]}


# -- weights ---------------------------------------------------------------


def leaf_shapes(d: Dims) -> List[Tuple[str, int, int]]:
    """(name, in, out) of one layer's int4 weights, in draw order."""
    q, kv = d.n_head * d.head_dim, d.n_kv_head * d.head_dim
    return [("wq", d.dim, q), ("wk", d.dim, kv), ("wv", d.dim, kv), ("wo", q, d.dim),
            ("w1", d.dim, d.intermediate), ("w3", d.dim, d.intermediate),
            ("w2", d.intermediate, d.dim)]


def make_weights(d: Dims, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    shapes = [s for _ in range(d.n_layer) for s in leaf_shapes(d)] + [("output", d.dim, d.vocab)]
    leaves = int4_leaves(gen, [(i, o) for _, i, o in shapes], d.group_size, device)
    emb = (0.02 * torch.randn((d.vocab, d.dim), device=device, generator=gen)).to(torch.bfloat16)
    norms = (1.0 + 0.1 * torch.randn((2 * d.n_layer + 1, d.dim), device=device,
                                     generator=gen)).to(torch.bfloat16)
    qkv = (d.n_head + 2 * d.n_kv_head) * d.head_dim
    bias = ((0.02 * torch.randn((d.n_layer, qkv), device=device, generator=gen))
            .to(torch.bfloat16) if d.qkv_bias else None)

    per = len(leaf_shapes(d))
    layers = []
    for li in range(d.n_layer):
        named = dict(zip([n for n, _, _ in leaf_shapes(d)], leaves[li * per:(li + 1) * per]))
        attn = {k: named[k] for k in ("wq", "wk", "wv", "wo")}
        if bias is not None:
            q, kv = d.n_head * d.head_dim, d.n_kv_head * d.head_dim
            attn.update(bq=bias[li, :q].clone(), bk=bias[li, q:q + kv].clone(),
                        bv=bias[li, q + kv:].clone())
        layers.append({"attn": attn, "ffn": {k: named[k] for k in ("w1", "w3", "w2")},
                       "attention_norm": norms[2 * li].clone(),
                       "ffn_norm": norms[2 * li + 1].clone()})
    return {"tok_embeddings": emb, "layers": layers, "norm": norms[-1].clone(),
            "output": leaves[-1]}


def weight_bytes(d: Dims) -> int:
    """Bytes the int4 layers and head hold (packed values, bf16 scales and
    zeros); the embedding is not in it."""
    shapes = [s for _ in range(d.n_layer) for s in leaf_shapes(d)] + [("output", d.dim, d.vocab)]
    return sum(i * o // 2 + 2 * 2 * (i // d.group_size) * o for _, i, o in shapes)


# -- work counts (``roofline.py`` has the yardstick) -------------------------


def layer_linears(d: Dims):
    """(in, out) of one layer's projections: qkv, o, gate|up, down."""
    q, kv = d.n_head * d.head_dim, d.n_kv_head * d.head_dim
    return [(d.dim, q + 2 * kv), (q, d.dim), (d.dim, 2 * d.intermediate), (d.intermediate, d.dim)]


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


def decode_gemv_seconds(d: Dims, B: int) -> float:
    """The int4 GEMVs of one decode step (K1/K2), each at its own bound."""
    per_step = sum(gemv(d, B, i, o).seconds() for i, o in layer_linears(d)) * d.n_layer
    return per_step + gemv(d, B, d.dim, d.vocab).seconds()


def decode_attention_seconds(d: Dims, B: int, C: int, bits: int) -> float:
    """Every layer's decode attention in one step (K3)."""
    return d.n_layer * decode_attention(d, B, C, bits).seconds()


def prefill_attention_seconds(d: Dims, lengths: Sequence[int]) -> float:
    """Every layer's causal prefill attention over one call's prompts (K4/K6)."""
    return d.n_layer * prefill_attention(d, lengths).seconds()
