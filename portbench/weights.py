"""Random int4 weights of a configuration, made on the device from a seed.

One draw for every packed weight byte, one for every scale and zero, one for
the embedding, the norms and the biases, in that order, from one
``torch.Generator`` on the device: the same seed gives the same tensors, so
the reference makes them again after the program's state is freed. The tree
is the port's unfused parameter tree (``layers[i]["attn"]["wq"]`` ...), each
int4 leaf ``{"w": int8 [in/2, out], "scales", "zeros": bf16 [in/gs, out],
"group_size"}``: byte r holds input row r in its low nibble (unsigned q) and
row r + in/2 in its high nibble (signed q - 8); ``w = (q - 8) * s + z``.
Scales are ``s = SCALE * U(0.5, 1.5)`` and zeros ``z = s * U(0, 1)`` (bf16),
so that every part of the dequantization carries weight and each group's
mean, ``z - s / 2`` (q is uniform over 0..15), is zero on average: weights
with a common offset would give every hidden state one shared direction,
and the model one token. Norms are ``1 + 0.1 N(0, 1)``, the embedding
``0.02 N(0, 1)``, biases ``0.02 N(0, 1)``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .spec import Dims

#: The scale of one int4 step: weights span about +-0.02, as
#: ``random_quantized_params`` of the port draws them.
SCALE = 0.02 / 8


def leaf_shapes(d: Dims) -> List[Tuple[str, int, int]]:
    """(name, in, out) of one layer's int4 weights, in draw order."""
    q, kv = d.n_head * d.head_dim, d.n_kv_head * d.head_dim
    return [("wq", d.dim, q), ("wk", d.dim, kv), ("wv", d.dim, kv), ("wo", q, d.dim),
            ("w1", d.dim, d.intermediate), ("w3", d.dim, d.intermediate),
            ("w2", d.intermediate, d.dim)]


def make_weights(d: Dims, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    gs = d.group_size
    shapes = [s for _ in range(d.n_layer) for s in leaf_shapes(d)] + [("output", d.dim, d.vocab)]
    n_bytes = sum(i * o // 2 for _, i, o in shapes)
    n_groups = sum(i // gs * o for _, i, o in shapes)
    packed = torch.randint(0, 256, (n_bytes,), dtype=torch.uint8, device=device,
                           generator=gen).view(torch.int8)
    u = torch.rand((2, n_groups), device=device, generator=gen)
    scales = (SCALE * (0.5 + u[0])).to(torch.bfloat16)
    zeros = (SCALE * (0.5 + u[0]) * u[1]).to(torch.bfloat16)
    del u
    emb = (0.02 * torch.randn((d.vocab, d.dim), device=device, generator=gen)).to(torch.bfloat16)
    norms = (1.0 + 0.1 * torch.randn((2 * d.n_layer + 1, d.dim), device=device,
                                     generator=gen)).to(torch.bfloat16)
    qkv = (d.n_head + 2 * d.n_kv_head) * d.head_dim
    bias = ((0.02 * torch.randn((d.n_layer, qkv), device=device, generator=gen))
            .to(torch.bfloat16) if d.qkv_bias else None)

    leaves = []
    ob = og = 0
    for _, i, o in shapes:
        nb, ng = i * o // 2, i // gs * o
        leaves.append({"w": packed[ob:ob + nb].view(i // 2, o),
                       "scales": scales[og:og + ng].view(i // gs, o),
                       "zeros": zeros[og:og + ng].view(i // gs, o), "group_size": gs})
        ob, og = ob + nb, og + ng
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
