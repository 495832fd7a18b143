"""Mellum2 (JetBrains/Mellum2-12B-A2.5B-Instruct): GQA attention in periods
of three sliding-window layers and one full layer, and a mixture of 64
SwiGLU experts (top 8, renormalised, no shared expert) in every layer. The
interface every architecture module gives is in ``arch/__init__.py``.

Weights: the port's unfused tree, each layer's ``attn`` (``wq`` ... ``wo``)
and ``moe`` (``router`` bf16 [D, E] and ``experts``: 64 ``{"w1", "w3",
"w2"}``), every projection, expert leaf and the head int4
(``weights.int4_leaves``, drawn per layer: ``wq wk wv wo`` then each
expert's ``w1 w3 w2``; the head last), then from the same generator the
embedding ``0.02 N(0, 1)``, the norms ``1 + 0.1 N(0, 1)`` and the routers
``0.02 N(0, 1)``, all bf16.

Work counts (``roofline.py``'s rules): a decode step reads each selected
expert's leaves once, and ``decode_step`` counts the distinct experts
uniform routing selects, ``E (1 - (1 - k/E)^B)`` (8 at B = 1, 26.5 at
B = 4), a fixed function of the model and the batch; ``moe_gemv_seconds``
takes the program's count instead. Prefill counts 8 experts per token.
Attention counts the true pairs: causal on the full layers, the window on
the sliding ones, and at decode the ring's 1024 slots there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from ..reference.mellum2 import FULL, SLIDING, Reference  # noqa: F401  (the interface's)
from ..roofline import Work, causal_pairs, gemv, int4_bytes
from ..weights import int4_leaves


@dataclass(frozen=True)
class Dims:
    """The sizes the benchmark's own code needs, from the published keys."""

    n_layer: int
    dim: int
    n_head: int
    n_kv_head: int
    head_dim: int
    expert_width: int
    n_experts: int
    top_k: int
    dense_width: int  # ``intermediate_size``: no layer of this model has a dense MLP
    vocab: int
    rope_theta: float
    yarn: Tuple[float, int, float, float, float]  # factor, original, beta_fast, beta_slow, scale
    sliding_window: int
    layer_types: Tuple[str, ...]
    norm_eps: float
    group_size: int

    @property
    def full_layers(self) -> int:
        return sum(t == FULL for t in self.layer_types)

    @property
    def sliding_layers(self) -> int:
        return self.n_layer - self.full_layers


def dims(doc: dict) -> Dims:
    rp = doc["rope_parameters"]
    full, slide = rp[FULL], rp[SLIDING]
    if full["rope_type"] != "yarn" or slide["rope_type"] != "default":
        raise ValueError(f"rope types {full['rope_type']} / {slide['rope_type']}")
    if float(full["rope_theta"]) != float(slide["rope_theta"]):
        raise ValueError("the port takes one rope theta for both layer kinds")
    if doc.get("mlp_layer_types") and set(doc["mlp_layer_types"]) != {"sparse"}:
        raise ValueError("every MLP is sparse in this architecture")
    if not doc["norm_topk_prob"]:
        raise ValueError("the reference renormalises the top-k weights")
    return Dims(
        n_layer=int(doc["num_hidden_layers"]), dim=int(doc["hidden_size"]),
        n_head=int(doc["num_attention_heads"]), n_kv_head=int(doc["num_key_value_heads"]),
        head_dim=int(doc["head_dim"]), expert_width=int(doc["moe_intermediate_size"]),
        n_experts=int(doc["num_experts"]), top_k=int(doc["num_experts_per_tok"]),
        dense_width=int(doc["intermediate_size"]),
        vocab=int(doc["vocab_size"]), rope_theta=float(full["rope_theta"]),
        yarn=(float(full["factor"]), int(full["original_max_position_embeddings"]),
              float(full["beta_fast"]), float(full["beta_slow"]),
              float(full["attention_factor"])),
        sliding_window=int(doc["sliding_window"]), layer_types=tuple(doc["layer_types"]),
        norm_eps=float(doc["rms_norm_eps"]), group_size=int(doc["port"]["weights"]["group_size"]),
    )


def checked_layer(d: Dims) -> int:
    """The first full layer (3): the cache policy under test lives there,
    and the sliding layers before it, with their experts, feed it, so that
    routing, the window and YaRN on its keys all reach the compared rows."""
    return d.layer_types.index(FULL)


def port_config(cell):
    """The port's ``ModelConfig``: the registry entry with the file's fields
    set, checked against every published size and the rope of each kind."""
    from cold_compress_tpu_torch.models.config import ModelConfig

    port = cell.config["port"]
    cfg = ModelConfig.from_name(port["registry_name"]).replace(**port["set"])
    d = cell.dims
    ys = cfg.rope_scaling
    want = {"n_layer": d.n_layer, "dim": d.dim, "n_head": d.n_head, "n_kv_head": d.n_kv_head,
            "head_dim": d.head_dim, "moe_intermediate_size": d.expert_width,
            "n_experts": d.n_experts, "n_experts_per_tok": d.top_k, "vocab_size": d.vocab,
            "rope_base": d.rope_theta, "norm_eps": d.norm_eps, "attention_bias": False,
            "sliding_window": d.sliding_window, "layer_types": d.layer_types,
            "norm_topk_prob": True, "intermediate_size": d.dense_width}
    got = {k: getattr(cfg, k) for k in want}
    want["every_mlp_sparse"], got["every_mlp_sparse"] = True, all(map(cfg.is_moe,
                                                                      range(cfg.n_layer)))
    want["yarn"] = ("yarn",) + d.yarn
    got["yarn"] = None if ys is None else (ys.rope_type, ys.factor,
                                           ys.original_max_position_embeddings, ys.beta_fast,
                                           ys.beta_slow, ys.attention_factor)
    wrong = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if wrong:
        raise ValueError(f"registry entry {port['registry_name']} differs from the "
                         f"configuration file: {wrong}")
    return cfg


def cache_kwargs(doc: dict, cfg) -> dict:
    """The mix's cache for the full layers; the program gives each sliding
    layer its ring of ``sliding_window`` slots itself."""
    return {"cache_strategy": [doc["strategy"]], "max_cache_length": [doc["max_cache_length"]],
            "prompt_compression_strategy": [doc["prompt_compression"]],
            "global_tokens": doc["global_tokens"], "recent_window": doc["recent_window"],
            "cache_bits": doc["bits"]}


# -- weights ---------------------------------------------------------------


def layer_shapes(d: Dims) -> List[Tuple[str, int, int]]:
    """(name, in, out) of one layer's int4 weights, in draw order."""
    q, kv, F = d.n_head * d.head_dim, d.n_kv_head * d.head_dim, d.expert_width
    attn = [("wq", d.dim, q), ("wk", d.dim, kv), ("wv", d.dim, kv), ("wo", q, d.dim)]
    return attn + [(f"{n}.{e}", i, o) for e in range(d.n_experts)
                   for n, i, o in (("w1", d.dim, F), ("w3", d.dim, F), ("w2", F, d.dim))]


def make_weights(d: Dims, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    per = layer_shapes(d)
    shapes = [(i, o) for _ in range(d.n_layer) for _, i, o in per] + [(d.dim, d.vocab)]
    leaves = int4_leaves(gen, shapes, d.group_size, device)
    emb = (0.02 * torch.randn((d.vocab, d.dim), device=device, generator=gen)).to(torch.bfloat16)
    norms = (1.0 + 0.1 * torch.randn((2 * d.n_layer + 1, d.dim), device=device,
                                     generator=gen)).to(torch.bfloat16)
    routers = (0.02 * torch.randn((d.n_layer, d.dim, d.n_experts), device=device,
                                  generator=gen)).to(torch.bfloat16)
    layers = []
    for li in range(d.n_layer):
        mine = leaves[li * len(per):(li + 1) * len(per)]
        attn = dict(zip(("wq", "wk", "wv", "wo"), mine[:4]))
        experts = [dict(zip(("w1", "w3", "w2"), mine[4 + 3 * e:7 + 3 * e]))
                   for e in range(d.n_experts)]
        layers.append({"attn": attn, "moe": {"router": routers[li].clone(), "experts": experts},
                       "attention_norm": norms[2 * li].clone(),
                       "ffn_norm": norms[2 * li + 1].clone()})
    return {"tok_embeddings": emb, "layers": layers, "norm": norms[-1].clone(),
            "output": leaves[-1]}


def weight_bytes(d: Dims) -> int:
    """Bytes the int4 layers, experts and head hold (packed values, bf16
    scales and zeros); the embedding and the routers are not in it."""
    shapes = [s for _ in range(d.n_layer) for s in layer_shapes(d)] + [("output", d.dim, d.vocab)]
    return sum(i * o // 2 + 2 * 2 * (i // d.group_size) * o for _, i, o in shapes)


# -- work counts (``roofline.py`` has the yardstick) -------------------------


def attention_linears(d: Dims):
    """(in, out) of one layer's attention projections: qkv and o."""
    q, kv = d.n_head * d.head_dim, d.n_kv_head * d.head_dim
    return [(d.dim, q + 2 * kv), (q, d.dim)]


def uniform_distinct(d: Dims, B: int) -> float:
    """Distinct experts B lanes select under uniform routing."""
    return d.n_experts * (1.0 - (1.0 - d.top_k / d.n_experts) ** B)


def expert_gemvs(d: Dims, B: int, distinct: float) -> Work:
    """One layer's grouped expert GEMV at decode (W4A8): each of the
    ``distinct`` experts' three leaves read once; per lane and expert the
    gate and up and the down products; x in and the combined row out in
    bf16."""
    F = d.expert_width
    pairs = B * d.top_k
    w = distinct * (int4_bytes(d.dim, 2 * F, d.group_size) + int4_bytes(F, d.dim, d.group_size))
    return Work(int8_ops=2.0 * pairs * 3 * d.dim * F, nbytes=w + 2.0 * 2 * B * d.dim)


def router(d: Dims, n: float) -> Work:
    """The router over n rows: bf16 weights read once, f32 logits out."""
    return Work(bf16_flops=2.0 * n * d.dim * d.n_experts,
                nbytes=2.0 * d.dim * d.n_experts + 2.0 * n * d.dim + 4.0 * n * d.n_experts)


def decode_attention(d: Dims, B: int, C: int, bits: int = 8, pooled: bool = True) -> Work:
    """One layer's decode attention over C slots a lane (``dense``'s count;
    a sliding layer returns no pooled probabilities)."""
    slot = d.n_kv_head * C * (2 * d.head_dim * bits / 8 + 4 * 4 + 1 + (4 if pooled else 0))
    act = 2 * 2 * d.n_head * d.head_dim
    return Work(int8_ops=2.0 * 2 * d.n_head * C * d.head_dim * B, nbytes=B * (slot + act))


def decode_step(d: Dims, B: int, C: int, bits: int = 8) -> Work:
    """A whole decode step: attention projections, the router, the experts
    uniform routing selects, every layer's attention (C slots on the full
    layers, the window's on the sliding ones) and the head."""
    w = Work()
    for IN, OUT in attention_linears(d):
        w = w + gemv(d, B, IN, OUT) * d.n_layer
    w = w + (router(d, B) + expert_gemvs(d, B, uniform_distinct(d, B))) * d.n_layer
    w = w + decode_attention(d, B, C, bits) * d.full_layers
    w = w + decode_attention(d, B, d.sliding_window, bits, pooled=False) * d.sliding_layers
    return w + gemv(d, B, d.dim, d.vocab)


def window_pairs(lengths: Sequence[int], window: int) -> float:
    return float(sum(sum(min(i + 1, window) for i in range(n)) for n in lengths))


def prefill_attention(d: Dims, lengths: Sequence[int], window: int = 0) -> Work:
    """One layer's prefill attention over the true pairs: causal with
    SnapKV's two f32 summaries out (a full layer), or the window's pairs
    and no summaries (a sliding layer)."""
    n = float(sum(lengths))
    pairs = window_pairs(lengths, window) if window else causal_pairs(lengths)
    io = n * (2 * (2 * d.n_head + 2 * d.n_kv_head) * d.head_dim
              + (0 if window else 2 * 4 * d.n_kv_head))
    return Work(bf16_flops=2.0 * 2 * d.head_dim * d.n_head * pairs, nbytes=io)


def prefill(d: Dims, lengths: Sequence[int]) -> Work:
    """A whole prefill: the attention projections and 8 experts per token
    in bf16 over the dequantized weights (each int4 byte read once, every
    expert's), the routers, the attention of both kinds, and the head over
    each prompt's last row (W4A8)."""
    n = float(sum(lengths))
    F = d.expert_width
    w = Work()
    for IN, OUT in attention_linears(d):
        w = w + Work(bf16_flops=2.0 * n * IN * OUT, nbytes=int4_bytes(IN, OUT, d.group_size)
                     + 2.0 * n * (IN + OUT)) * d.n_layer
    experts = Work(bf16_flops=2.0 * n * d.top_k * 3 * d.dim * F,
                   nbytes=d.n_experts * (int4_bytes(d.dim, 2 * F, d.group_size)
                                         + int4_bytes(F, d.dim, d.group_size)) + 2.0 * 2 * n * d.dim)
    w = w + (experts + router(d, n)) * d.n_layer
    w = w + prefill_attention(d, lengths) * d.full_layers
    w = w + prefill_attention(d, lengths, d.sliding_window) * d.sliding_layers
    return w + gemv(d, len(lengths), d.dim, d.vocab)


def decode_gemv_seconds(d: Dims, B: int) -> float:
    """Every int4 GEMV of one decode step, each at its own bound: the
    attention projections and head (K1/K2) and the grouped experts at
    uniform routing's distinct count (its kernel's name holds K1's, so
    ``qmm_gemv_roofline_pct`` reads its time too)."""
    per_layer = sum(gemv(d, B, i, o).seconds() for i, o in attention_linears(d))
    per_layer += expert_gemvs(d, B, uniform_distinct(d, B)).seconds()
    return per_layer * d.n_layer + gemv(d, B, d.dim, d.vocab).seconds()


def moe_gemv_seconds(d: Dims, B: int, distinct: float) -> float:
    """The grouped expert GEMV of one decode step (every layer's two
    launches) at ``distinct`` experts a layer: the program's counter."""
    return d.n_layer * expert_gemvs(d, B, distinct).seconds()


def decode_attention_seconds(d: Dims, B: int, C: int, bits: int) -> float:
    """Every layer's decode attention in one step (K3)."""
    return (d.full_layers * decode_attention(d, B, C, bits).seconds()
            + d.sliding_layers * decode_attention(d, B, d.sliding_window, bits,
                                                  pooled=False).seconds())


def prefill_attention_seconds(d: Dims, lengths: Sequence[int]) -> float:
    """Every layer's prefill attention over one call's prompts (K4)."""
    return (d.full_layers * prefill_attention(d, lengths).seconds()
            + d.sliding_layers * prefill_attention(d, lengths, d.sliding_window).seconds())
