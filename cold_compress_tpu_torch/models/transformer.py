"""Decoder-only transformer (Llama family) as ``nn.Module``s.

Port of ``cold_compress_tpu/models/transformer.py``. Weights are ``[in,
out]`` as in the JAX package; the q/k/v and w1/w3 projections are fused
(``fuse_layer_params``) before the modules are built. Caches are a list of
per-layer ``CacheState``s updated in place. The dataflow contract is the
reference's:

  * decode inserts the new token into the cache BEFORE attention;
  * prefill runs full causal attention FIRST, then (optionally) compresses
    the prompt and fills the cache.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..caches import (
    CacheState,
    compress_prompt,
    decode_update,
    get_cache_strategy,
    get_prompt_compressor,
    materialize_kv,
    prefill_update,
    strategy_needs_attn,
)
from ..device import resolve_device
from ..ops.attention import gqa_attention, prefill_attention
from ..ops.decode_attn import I8DOT_MODES, decode_attention, decode_attn_supported, i8dot_route
from ..ops.linear import DenseLinear, Int8Linear, QuantizedLinear
from .config import ModelConfig
from .rope import apply_rotary_emb, precompute_freqs_cis

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------


def make_linear(leaf, name: str, bias: Optional[torch.Tensor] = None) -> nn.Module:
    """Module for one weight leaf: a dense [in, out] tensor, an int4 rowpack
    dict ``{"w", "scales", "zeros", "group_size"}`` or an int8 dict
    ``{"kind": "int8", "w", "scales"}``, each quantized kind repacked once
    into its kernel's layout. ``name`` (``wqkv``, ``wo``, ``w13``, ``w2``,
    ``head``) names the kernel's launch counter."""
    if isinstance(leaf, dict) and leaf.get("kind") == "int8":
        return Int8Linear(leaf["w"], leaf["scales"], bias, counter=f"w8a8_gemv.{name}")
    if isinstance(leaf, dict):
        return QuantizedLinear.from_rowpack(
            leaf["w"], leaf["scales"], leaf["zeros"], leaf["group_size"],
            bias=bias, counter=f"w4a8_gemv.{name}",
        )
    return DenseLinear(leaf, bias)


class Attention(nn.Module):
    def __init__(self, p: Params):
        super().__init__()
        self.wqkv = make_linear(p["wqkv"], "wqkv", p.get("bqkv"))
        self.wo = make_linear(p["wo"], "wo")


class FeedForward(nn.Module):
    def __init__(self, p: Params):
        super().__init__()
        self.w13 = make_linear(p["w13"], "w13")
        self.w2 = make_linear(p["w2"], "w2")


class Block(nn.Module):
    def __init__(self, p: Params):
        super().__init__()
        self.attention = Attention(p["attn"])
        self.feed_forward = FeedForward(p["ffn"])
        self.register_buffer("attention_norm", p["attention_norm"])
        self.register_buffer("ffn_norm", p["ffn_norm"])


class Transformer(nn.Module):
    """The model: embeddings, blocks, final norm, vocab head and the rope
    table. ``params`` is a fused parameter tree of tensors on one device
    (``runtime/engine.py::params_from_flat`` builds it). ``attn_i8dot`` is
    decode attention's ``i8dot`` mode (``set_attn_i8dot``). ``tp`` is the
    rank's ``parallel.mesh.TpContext`` when the model is one rank of a
    (dp, tp) layout (``parallel/tp_decode.py::build_tp_model``; ``cfg`` is
    then the local config): at tp > 1 the blocks' two residual adds sum
    their branch over the tp group and the vocab-sharded logits are
    gathered. None on a single device. ``sp`` and ``pp`` are the rank's
    ``parallel.mesh.SpContext`` / ``PpContext`` under sequence or pipeline
    parallelism (``parallel/tp_decode.py::build_rank_model``): they change
    only the prefill (``parallel/sp.py``, ``parallel/pp.py``); None
    otherwise."""

    def __init__(self, cfg: ModelConfig, params: Params, rope: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.attn_i8dot = "auto"
        self.tp = None
        self.sp = None
        self.pp = None
        self.register_buffer("tok_embeddings", params["tok_embeddings"])
        self.layers = nn.ModuleList(Block(lp) for lp in params["layers"])
        self.register_buffer("norm", params["norm"])
        out = params["output"]
        self.output = None if out is None else make_linear(out, "head")
        self.register_buffer("rope", rope)

    @property
    def device(self) -> torch.device:
        return self.tok_embeddings.device


def set_prefill_w4a8(model: Transformer, on: bool) -> None:
    """Route (or stop routing) the prefill of the four int4 layer
    projections through the W4A8 prefill kernel (K8) instead of bf16
    dequantization. The head sees one row at prefill and stays on K2."""
    for layer in model.layers:
        for lin in (layer.attention.wqkv, layer.attention.wo, layer.feed_forward.w13,
                    layer.feed_forward.w2):
            if not isinstance(lin, QuantizedLinear):
                raise ValueError("prefill_w4a8 needs int4 layer weights")
            lin.prefill_w4a8 = on


def set_attn_i8dot(model: Transformer, mode) -> None:
    """Choose decode attention's branch over a quantized cache (the explicit
    counterpart of the JAX package's ``CCT_ATTN_I8DOT``): ``"auto"`` (the
    default) the TPU program's choice, the integer ``i8dot`` branch for an
    int8 cache where the TPU runs its kernel and the dequantizing branch
    elsewhere (``ops/decode_attn.py::i8dot_route``); True the ``i8dot``
    branch at every quantized cache (a bf16 cache then raises at decode);
    False the dequantizing branch everywhere."""
    if not (mode == "auto" or isinstance(mode, bool)):
        raise ValueError(f"attn_i8dot mode {mode!r} (takes {I8DOT_MODES})")
    model.attn_i8dot = mode


def make_rope_table(cfg: ModelConfig, max_positions: Optional[int] = None,
                    device=None) -> torch.Tensor:
    """Rope rows for positions [0, n), truncated to the run's length."""
    n = cfg.block_size
    if max_positions is not None:
        n = min(n, max(int(max_positions), 16))
    return precompute_freqs_cis(n, cfg.head_dim, cfg.rope_base, cfg.rope_scaling, device)


# --------------------------------------------------------------------------
# Building blocks
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back, then scaled."""
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight


def feed_forward(ffn: FeedForward, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP over the fused gate|up projection."""
    y = ffn.w13(x)
    F = y.shape[-1] // 2
    return ffn.w2(nn.functional.silu(y[..., :F]) * y[..., F:])


def _qkv(cfg: ModelConfig, attn: Attention, x: torch.Tensor, freqs: torch.Tensor):
    """Project + rotate. x [B, L, D] -> q [B,H,L,hd], k/v [B,KVH,L,hd]."""
    B, L, _ = x.shape
    Dq = cfg.n_head * cfg.head_dim
    Dkv = cfg.n_kv_head * cfg.head_dim
    y = attn.wqkv(x)
    q = y[..., :Dq].reshape(B, L, cfg.n_head, cfg.head_dim)
    k = y[..., Dq : Dq + Dkv].reshape(B, L, cfg.n_kv_head, cfg.head_dim)
    v = y[..., Dq + Dkv :].reshape(B, L, cfg.n_kv_head, cfg.head_dim)
    q = apply_rotary_emb(q, freqs)
    k = apply_rotary_emb(k, freqs)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


# --------------------------------------------------------------------------
# Attention layers
# --------------------------------------------------------------------------


def attention_prefill(cfg, attn: Attention, x, cache: CacheState, input_pos, valid,
                      prompt_len, freqs, tokens=None):
    """Prefill attention + cache fill: full causal attention first, then
    prompt compression when the budget is below the padded prompt length.
    A profiling strategy (hybrid) replaces both by one attention pass that
    also profiles the heads (K6), then fills from the profile; ``tokens``
    [B, P] are the ids it classifies."""
    spec = cache.spec
    strategy = get_cache_strategy(spec.cache_strategy)
    compressor = get_prompt_compressor(spec.prompt_compression_strategy)
    B, P, _ = x.shape
    compress = spec.max_cache_length < P
    q, k, v = _qkv(cfg, attn, x, freqs)
    if hasattr(strategy, "profile_prefill_with_attn"):
        y = strategy.profile_prefill_with_attn(spec, cache, q, k, v, tokens, input_pos, valid,
                                               prompt_len)
    else:
        need_summary = strategy_needs_attn(strategy, spec) or (
            compress and compressor.needs_attn
        )
        y, summary = prefill_attention(q, k, v, valid, prompt_len, need_summary=need_summary)
        fill_from_kv(strategy, compressor, cache, k, v, summary, input_pos, valid, prompt_len)
    y = y.transpose(1, 2).reshape(B, P, cfg.n_head * cfg.head_dim)
    return attn.wo(y)


def fill_from_kv(strategy, compressor, cache: CacheState, k, v, summary, input_pos,
                 valid, prompt_len) -> CacheState:
    """Prompt compression + cache fill from full-sequence K/V and the
    attention summaries, in place; then an analysis (``debug_*``) cache
    fills its shadow."""
    spec = cache.spec
    compress = spec.max_cache_length < k.shape[2]
    if compress and compressor.name != "full":
        keep_pos, k_c, v_c, keep_valid, kept_attn = compress_prompt(
            compressor, spec, input_pos, k, v, valid, prompt_len, summary=summary
        )
        prefill_update(strategy, cache, keep_pos, k_c, v_c, keep_valid)
        if kept_attn is None and strategy_needs_attn(strategy, spec):
            kept_attn = summary["cum_mean"].gather(-1, keep_pos.long())
    else:
        if compress:
            raise ValueError(
                "Prompt exceeds the cache budget but the prompt compressor is "
                "'full' (pass-through); choose a real compression strategy."
            )
        prefill_update(strategy, cache, input_pos[None, None, :], k, v, valid[:, None, :])
        kept_attn = summary["cum_mean"] if strategy_needs_attn(strategy, spec) else None
    strategy.update_state(spec, cache, input_pos, kept_attn, is_prefill=True,
                          prompt_len=prompt_len)
    if hasattr(strategy, "post_prefill"):
        strategy.post_prefill(spec, cache, k, v, summary, input_pos, valid, prompt_len)
    return cache


def attention_decode(cfg, attn: Attention, x, cache: CacheState, input_pos, freqs,
                     attn_top_k: float = 1.0, token=None, i8dot="auto"):
    """Single-token decode attention over the fixed-budget cache; the new
    token is inserted BEFORE attention so it attends to itself. ``token``
    [B] is the current id (hybrid tracks punctuation with it).

    Every cache precision (bf16, int8, int4, int2) goes to the decode
    kernel (K3/K5), which reads the cache as stored, never dequantized in
    device memory, in the branch that ``i8dot`` (a ``set_attn_i8dot`` mode)
    routes it to. Only what the JAX package also leaves to XLA takes the
    plain math over ``materialize_kv`` (models/transformer.py:311 there):
    ``attn_top_k < 1``, head_dim other than 128, more than 8 query heads
    per KV head."""
    spec = cache.spec
    strategy = get_cache_strategy(spec.cache_strategy)
    B = x.shape[0]
    q, k, v = _qkv(cfg, attn, x, freqs)
    decode_update(strategy, cache, input_pos, k, v, token=token)
    need_attn = strategy_needs_attn(strategy, spec)
    if attn_top_k >= 1.0 and decode_attn_supported(q.shape, cfg.n_kv_head):
        bits = spec.cache_bits or 16
        y, pooled = decode_attention(
            q, cache.k, cache.v, cache.k_scales, cache.k_zeros, cache.v_scales,
            cache.v_zeros, cache.mask, bits=bits, need_attn=need_attn,
            i8dot=i8dot_route(i8dot, bits, cache.k.shape[2], cfg.n_kv_head, cfg.head_dim),
        )
    else:
        k_cache, v_cache = materialize_kv(cache, dtype=k.dtype)
        y, pooled = gqa_attention(
            q, k_cache, v_cache, mask=cache.mask[:, :, None, None, :],
            return_attn=need_attn, attn_top_k=attn_top_k,
        )
    if need_attn:
        strategy.update_state(spec, cache, input_pos, pooled[:, :, 0], is_prefill=False)
    y = y.transpose(1, 2).reshape(B, 1, cfg.n_head * cfg.head_dim)
    return attn.wo(y)


# --------------------------------------------------------------------------
# Full model forward
# --------------------------------------------------------------------------


def _block(cfg, layer: Block, x, attn_out, tp=None):
    """The two residual adds of a block. A tensor-parallel shard's attention
    and FFN outputs are partial sums over its heads and columns: each is
    summed over the tp group first (the JAX package's two ``psum``s)."""
    total = (lambda y: y) if tp is None else tp.all_reduce
    h = x + total(attn_out)
    return h + total(feed_forward(layer.feed_forward, rms_norm(h, layer.ffn_norm, cfg.norm_eps)))


def _logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    """f32 logits of the final hidden states. A tensor-parallel shard's head
    holds a block of the vocabulary: the blocks are gathered in shard order
    (tied embeddings stay whole on every rank, with no gather)."""
    cfg = model.cfg
    x = rms_norm(x, model.norm, cfg.norm_eps)
    if model.output is None:  # tied embeddings
        return torch.matmul(x.float(), model.tok_embeddings.float().t())
    if isinstance(model.output, (QuantizedLinear, Int8Linear)):
        logits = model.output(x).float()
    else:
        logits = torch.matmul(x.float(), model.output.weight.float())
    return logits if model.tp is None else model.tp.gather_last(logits)


def _embed(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    emb = model.tok_embeddings
    return emb[tokens.clamp(0, emb.shape[0] - 1)]


def prefill(model: Transformer, caches: Sequence[CacheState], tokens: torch.Tensor,
            prompt_len):
    """Run the (padded) prompt through the model, filling every cache in
    place. Returns last-valid-position logits [B, vocab] f32."""
    cfg = model.cfg
    dev = tokens.device
    B, P = tokens.shape
    input_pos = torch.arange(P, dtype=torch.int32, device=dev)
    plen = torch.as_tensor(prompt_len, dtype=torch.int32, device=dev).reshape(-1)
    valid = (input_pos[None, :] < plen[:, None]).expand(B, P)
    freqs = model.rope[:P]
    x = _embed(model, tokens)
    for layer, cache in zip(model.layers, caches):
        attn_out = attention_prefill(
            cfg, layer.attention, rms_norm(x, layer.attention_norm, cfg.norm_eps),
            cache, input_pos, valid, prompt_len, freqs, tokens=tokens,
        )
        x = _block(cfg, layer, x, attn_out, model.tp)
    last = x[torch.arange(B, device=dev), plen.expand(B).long() - 1]
    return _logits(model, last[:, None])[:, 0]


def decode_step(model: Transformer, caches: Sequence[CacheState], token: torch.Tensor,
                input_pos, attn_top_k: float = 1.0):
    """One decode step for token [B] at position ``input_pos`` (a 0-d or [B]
    int tensor on the model's device, or an int). Returns logits [B, vocab]
    f32; caches update in place. The position stays a device tensor down to
    the caches and the rope rows, so one captured step serves every position
    (``runtime/generate.py::decode_loop_core``); an int is written to one
    by a fill. ``attn_top_k < 1`` keeps only that share of the top-scored
    cache slots in the value sum (ops/attention.py::gqa_attention)."""
    cfg = model.cfg
    B = token.shape[0]
    if not isinstance(input_pos, torch.Tensor):
        input_pos = torch.full((B,), int(input_pos), dtype=torch.int32, device=token.device)
    freqs = model.rope[input_pos.reshape(-1).long()][:, None]  # [1 or B, 1, hd/2, 2]
    x = _embed(model, token[:, None])
    for layer, cache in zip(model.layers, caches):
        attn_out = attention_decode(
            cfg, layer.attention, rms_norm(x, layer.attention_norm, cfg.norm_eps),
            cache, input_pos, freqs, attn_top_k, token=token, i8dot=model.attn_i8dot,
        )
        x = _block(cfg, layer, x, attn_out, model.tp)
    return _logits(model, x)[:, 0]


# --------------------------------------------------------------------------
# Caches and parameter trees
# --------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, specs, batch_size: int = 1, dtype=torch.bfloat16,
                device=None) -> List[CacheState]:
    """One cache state per layer, on ``device`` (the card unless the caller
    asks for the CPU)."""
    if len(specs) != cfg.n_layer:
        raise ValueError(f"{len(specs)} cache specs for {cfg.n_layer} layers")
    device = resolve_device(device)
    return [
        get_cache_strategy(spec.cache_strategy).init(
            spec, batch_size, cfg.n_kv_head, cfg.head_dim, dtype, device=device
        )
        for spec in specs
    ]


def _concat_leaves(leaves):
    """Concatenate weight leaves along the output (last) axis: dense tensors,
    int4 rowpack dicts (bytes, scales and zeros all end in the output axis)
    or int8 dicts (``w`` [in, out], ``scales`` [out]), so the fused
    projection computes exactly the unfused ones."""
    first = leaves[0]
    if isinstance(first, dict):
        kind, gs = first.get("kind"), first["group_size"]
        if not all(isinstance(l, dict) and l.get("kind") == kind and l["group_size"] == gs
                   for l in leaves):
            raise ValueError("fused projections must share quantization settings")
        keys = ("w", "scales") if kind == "int8" else ("w", "scales", "zeros")
        return {key: torch.cat([l[key] for l in leaves], dim=-1) for key in keys} | {
            k: first[k] for k in ("kind", "group_size") if k in first}
    if any(isinstance(l, dict) for l in leaves):
        raise ValueError("fused projections must share quantization settings")
    return torch.cat(leaves, dim=-1)


def fuse_layer_params(params: Params) -> Params:
    """Fuse q/k/v into ``wqkv`` and w1/w3 into ``w13`` (output axis)."""

    def fuse_one(lp):
        attn = dict(lp["attn"])
        if "wq" in attn:
            attn["wqkv"] = _concat_leaves([attn.pop("wq"), attn.pop("wk"), attn.pop("wv")])
            if "bq" in attn:
                attn["bqkv"] = torch.cat([attn.pop("bq"), attn.pop("bk"), attn.pop("bv")], -1)
        ffn = dict(lp["ffn"])
        if "w1" in ffn:
            ffn["w13"] = _concat_leaves([ffn.pop("w1"), ffn.pop("w3")])
        return {**lp, "attn": attn, "ffn": ffn}

    return {**params, "layers": [fuse_one(lp) for lp in params["layers"]]}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device=None) -> Params:
    """Random-normal weights (``0.02 * N(0, 1)`` drawn in f32, cast to
    ``dtype``) in the JAX package's ``init_params`` layout: the same shapes,
    dtypes and order, unfused, norms one, biases zero. The values come from
    ``generator`` (seeded 0 when omitted) on ``device``, not from JAX's
    keys; parity with the JAX package goes through checkpoints."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    D, H, KVH, hd, I = cfg.dim, cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.intermediate_size

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    layers = []
    for _ in range(cfg.n_layer):
        attn = {"wq": dense(D, H * hd), "wk": dense(D, KVH * hd), "wv": dense(D, KVH * hd),
                "wo": dense(H * hd, D)}
        if cfg.attention_bias:
            attn |= {"bq": torch.zeros(H * hd, dtype=dtype, device=dev),
                     "bk": torch.zeros(KVH * hd, dtype=dtype, device=dev),
                     "bv": torch.zeros(KVH * hd, dtype=dtype, device=dev)}
        layers.append({
            "attn": attn,
            "ffn": {"w1": dense(D, I), "w3": dense(D, I), "w2": dense(I, D)},
            "attention_norm": torch.ones(D, dtype=dtype, device=dev),
            "ffn_norm": torch.ones(D, dtype=dtype, device=dev),
        })
    return {
        "tok_embeddings": dense(cfg.vocab_size, D),
        "layers": layers,
        "norm": torch.ones(D, dtype=dtype, device=dev),
        "output": None if cfg.tie_word_embeddings else dense(D, cfg.vocab_size),
    }


def model_size_bytes(params: Params) -> int:
    """Bytes of every parameter tensor but the token embeddings (the JAX
    package's ``model_size_bytes`` on the same tree)."""

    def size(node) -> int:
        if isinstance(node, torch.Tensor):
            return node.numel() * node.element_size()
        if isinstance(node, dict):
            return sum(size(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return sum(size(v) for v in node)
        return 0

    return sum(size(v) for k, v in params.items() if k != "tok_embeddings")
