"""Random int4 group-wise weights, drawn with numpy alone.

Port of ``cold_compress_tpu/quantization/weight_quant.py::
random_quantized_params`` (int4 layers; an int4 or int8 vocab head): the same
``np.random.RandomState(seed)`` draws in the same order give byte-identical
packed weights and scales. The result is returned in the flat key scheme
that ``cold_compress_tpu/runtime/engine.py::save_params`` writes (``a/b/c``
paths, ``#bf16`` uint16 views, ``qmeta = [bits, group_size]``), which
``runtime/engine.py::params_from_flat`` turns into a model.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.config import ModelConfig

QUANTIZABLE = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def effective_group_size(in_dim: int, group_size: int) -> int:
    """Largest divisor of in_dim that is <= group_size."""
    g = min(group_size, in_dim)
    while in_dim % g != 0:
        g -= 1
    return g


def bf16_bits(t) -> np.ndarray:
    """Float tensor (or Python float) -> uint16 bit patterns of its bf16
    rounding."""
    if not isinstance(t, torch.Tensor):
        t = torch.tensor(t, dtype=torch.float32)
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def random_quantized_params(cfg: ModelConfig, seed: int = 0, mode: str = "int4",
                            group_size: int = 128,
                            head_mode: str = "int4") -> Dict[str, np.ndarray]:
    """Random int4 weights in the flat checkpoint key scheme (see module
    docstring). Only ``mode="int4"`` is ported; ``head_mode`` is ``"int4"``
    or ``"int8"`` (values ``(byte % 255) - 127``, scales ``0.02 / 127``)."""
    if mode != "int4" or head_mode not in ("int4", "int8"):
        raise ValueError("the port supports int4 layers and an int4 or int8 vocab head only")
    rng = np.random.RandomState(seed)
    D, H, KVH, hd, I = cfg.dim, cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.intermediate_size
    scale_bits = bf16_bits(0.02 / 8)
    one_bits = bf16_bits(1.0)
    zero_bits = bf16_bits(0.0)
    flat: Dict[str, np.ndarray] = {}

    def rand_bytes(shape):
        n = int(np.prod(shape))
        return np.frombuffer(rng.bytes(n), dtype=np.uint8).reshape(shape)

    def rand_q(prefix, in_dim, out_dim):
        gs = effective_group_size(in_dim, group_size)
        flat[prefix + "w"] = rand_bytes((in_dim // 2, out_dim)).view(np.int8)
        flat[prefix + "scales#bf16"] = np.full((in_dim // gs, out_dim), scale_bits, np.uint16)
        flat[prefix + "zeros#bf16"] = np.full((in_dim // gs, out_dim), zero_bits, np.uint16)
        flat[prefix + "qmeta"] = np.array([4, gs])

    for i in range(cfg.n_layer):
        p = f"layers/{i}/"
        rand_q(p + "attn/wq/", D, H * hd)
        rand_q(p + "attn/wk/", D, KVH * hd)
        rand_q(p + "attn/wv/", D, KVH * hd)
        rand_q(p + "attn/wo/", H * hd, D)
        rand_q(p + "ffn/w1/", D, I)
        rand_q(p + "ffn/w3/", D, I)
        rand_q(p + "ffn/w2/", I, D)
        if cfg.attention_bias:
            flat[p + "attn/bq#bf16"] = np.full((H * hd,), zero_bits, np.uint16)
            flat[p + "attn/bk#bf16"] = np.full((KVH * hd,), zero_bits, np.uint16)
            flat[p + "attn/bv#bf16"] = np.full((KVH * hd,), zero_bits, np.uint16)
        flat[p + "attention_norm#bf16"] = np.full((D,), one_bits, np.uint16)
        flat[p + "ffn_norm#bf16"] = np.full((D,), one_bits, np.uint16)
    emb = (rng.standard_normal((cfg.vocab_size, D)).astype(np.float32) * 0.02).astype(
        np.float16
    )
    flat["tok_embeddings#bf16"] = bf16_bits(torch.from_numpy(emb))
    flat["norm#bf16"] = np.full((D,), one_bits, np.uint16)
    if cfg.tie_word_embeddings:
        flat["output#none"] = np.zeros((0,))
    elif head_mode == "int4":
        rand_q("output/", D, cfg.vocab_size)
    else:
        # int8 wraps in numpy exactly as in the JAX package: (v % 255) - 127.
        flat["output/w"] = (rand_bytes((D, cfg.vocab_size)) % 255).astype(np.int8) - 127
        flat["output/scales"] = np.full((cfg.vocab_size,), 0.02 / 127, np.float32)
        flat["output/qmeta"] = np.array([8, group_size])
    return flat
