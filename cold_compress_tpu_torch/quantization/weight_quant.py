"""Weight-only quantization: int8 per-channel and int4 group-wise, and random
quantized weights drawn with numpy alone.

Port of ``cold_compress_tpu/quantization/weight_quant.py``. A quantized leaf
of the port's parameter tree is a dict (``runtime/engine.py`` reads and
writes it in the flat checkpoint key scheme):

  int8: ``{"kind": "int8", "w": int8 [in, out], "scales": f32 [out],
  "group_size": int}``
  int4: ``{"w": int8 [in/2, out] rowpack, "scales"/"zeros": bf16 [in/gs,
  out], "group_size": int}``; byte r holds input row r in its low nibble
  (unsigned q) and row r + in/2 in its high nibble, stored signed as q - 8;
  ``dequant = (q - 8) * scale + zero``.

``quantize_weight_int8``/``quantize_weight_int4`` give the JAX functions'
bytes on the same input: the same f32 true divisions (as tensor divisions,
never a multiplication by a reciprocal), round half to even, the zeros
``mn + 8 * scales`` formed in f32 before the bf16 cast. They run on the
tensor's device, one leaf at a time.

``random_quantized_params`` draws the JAX function's ``np.random.RandomState
(seed)`` bytes in the same order, so its packed weights and scales are
byte-identical, returned in the flat key scheme.
"""

from __future__ import annotations

from typing import Any, Dict

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


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as an f32 tensor on x's device: dividing by a tensor keeps
    the true division on every device (a Python scalar divisor may be
    turned into a multiplication by its reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=x.device)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Unsigned nibbles [in, out] (0..15) -> rowpack int8 bytes [in/2, out]:
    byte r holds row r (low nibble) and row r + in/2 (high nibble, signed
    q - 8), as ``ops/linear.py::pack_int4`` of the JAX package packs them."""
    n = q.shape[0]
    if n % 2:
        raise ValueError(f"int4 packing needs an even input dimension, got {n}")
    v = q.to(torch.int16)
    byte = v[: n // 2] | (((v[n // 2:] - 8) & 0xF) << 4)
    return byte.to(torch.uint8).view(torch.int8)


def quantize_weight_int8(w: torch.Tensor) -> Dict[str, Any]:
    """Symmetric per-output-channel int8: ``scales = max(|w|, 1e-8) / 127``
    per column, ``q = clip(round(w / scales), -128, 127)``, in f32."""
    wf = w.float()
    scales = wf.abs().amax(dim=0).clamp_min(1e-8) / _const(wf, 127.0)
    q = torch.round(wf / scales[None, :]).clamp(-128, 127).to(torch.int8)
    return {"kind": "int8", "w": q, "scales": scales, "group_size": 128}


def quantize_weight_int4(w: torch.Tensor, group_size: int = 128) -> Dict[str, Any]:
    """Group-wise affine uint4 along the input axis, rowpack-packed: per
    group ``scales = max(mx - mn, 1e-6) / 15``, ``zeros = mn + 8 * scales``
    (f32, then bf16), ``q = clip(round((w - mn) / scales), 0, 15)``."""
    wf = w.float()
    in_dim, out_dim = wf.shape
    gs = effective_group_size(in_dim, group_size)
    g = wf.reshape(in_dim // gs, gs, out_dim)
    mn = g.amin(dim=1)
    mx = g.amax(dim=1)
    scales = (mx - mn).clamp_min(1e-6) / _const(wf, 15.0)
    zeros = mn + scales * 8.0
    q = torch.round((g - mn[:, None, :]) / scales[:, None, :]).clamp(0, 15)
    return {
        "w": pack_int4(q.reshape(in_dim, out_dim).to(torch.uint8)),
        "scales": scales.to(torch.bfloat16),
        "zeros": zeros.to(torch.bfloat16),
        "group_size": gs,
    }


def quantize_params(params: Dict[str, Any], mode: str = "int8", group_size: int = 128,
                    quantize_output: bool = True, output_mode: str = "int8") -> Dict[str, Any]:
    """Quantize every linear weight of a parameter tree (``QUANTIZABLE`` in
    each layer's ``attn``/``ffn``, and the vocab head in ``output_mode``
    unless ``quantize_output`` is false); embeddings and norms stay as they
    are. Leaf by leaf, on the leaves' device: the whole model is never held
    in f32."""

    def qz(w, m=None):
        m = m or mode
        if w is None or isinstance(w, dict):  # absent, or quantized already
            return w
        if m == "int8":
            return quantize_weight_int8(w)
        if m == "int4":
            return quantize_weight_int4(w, group_size)
        raise ValueError(f"Unknown quantization mode: {m}")

    out = {
        "tok_embeddings": params["tok_embeddings"],
        "norm": params["norm"],
        "output": qz(params["output"], output_mode) if quantize_output else params["output"],
        "layers": [],
    }
    for lp in params["layers"]:
        out["layers"].append({
            "attn": {k: qz(v) if k in QUANTIZABLE else v for k, v in lp["attn"].items()},
            "ffn": {k: qz(v) if k in QUANTIZABLE else v for k, v in lp["ffn"].items()},
            "attention_norm": lp["attention_norm"],
            "ffn_norm": lp["ffn_norm"],
        })
    return out


def random_quantized_params(cfg: ModelConfig, seed: int = 0, mode: str = "int4",
                            group_size: int = 128,
                            head_mode: str = "int4") -> Dict[str, np.ndarray]:
    """Random quantized weights in the flat checkpoint key scheme (see
    module docstring). ``mode`` ``"int4"`` or ``"int8"`` sets the layers;
    ``head_mode`` ``"int4"`` gives the head the layers' kind (int8 under
    ``mode="int8"``, as in the JAX package), ``"int8"`` an int8 head. int8
    values are ``(byte % 255) - 127`` with scales ``0.02 / 127``; int4 scales
    ``0.02 / 8`` and zeros 0."""
    if mode not in ("int4", "int8") or head_mode not in ("int4", "int8"):
        raise ValueError(f"unknown mode {mode!r} / head_mode {head_mode!r} (int4 or int8)")
    rng = np.random.RandomState(seed)
    D, H, KVH, hd, I = cfg.dim, cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.intermediate_size
    scale_bits = bf16_bits(0.02 / 8)
    one_bits = bf16_bits(1.0)
    zero_bits = bf16_bits(0.0)
    flat: Dict[str, np.ndarray] = {}

    def rand_bytes(shape):
        n = int(np.prod(shape))
        return np.frombuffer(rng.bytes(n), dtype=np.uint8).reshape(shape)

    def rand_q8(prefix, in_dim, out_dim):
        # int8 wraps in numpy exactly as in the JAX package: (v % 255) - 127.
        flat[prefix + "w"] = (rand_bytes((in_dim, out_dim)) % 255).astype(np.int8) - 127
        flat[prefix + "scales"] = np.full((out_dim,), 0.02 / 127, np.float32)
        flat[prefix + "qmeta"] = np.array([8, 128])  # int8 leaves keep the default 128

    def rand_q(prefix, in_dim, out_dim):
        if mode == "int8":
            return rand_q8(prefix, in_dim, out_dim)
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
        if cfg.is_moe(i):  # no JAX counterpart: router bf16, then each expert
            F = cfg.moe_intermediate_size
            router = rng.standard_normal((D, cfg.n_experts)).astype(np.float32) * 0.02
            flat[p + "moe/router#bf16"] = bf16_bits(torch.from_numpy(router))
            for e in range(cfg.n_experts):
                rand_q(p + f"moe/experts/{e}/w1/", D, F)
                rand_q(p + f"moe/experts/{e}/w3/", D, F)
                rand_q(p + f"moe/experts/{e}/w2/", F, D)
        else:
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
        rand_q8("output/", D, cfg.vocab_size)
    return flat
