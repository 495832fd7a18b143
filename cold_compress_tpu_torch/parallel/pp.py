"""Pipeline-parallel (PP) prefill over ranks.

Counterpart of ``cold_compress_tpu/parallel/pp.py::pp_prefill`` (the mesh is
``mesh.make_pp_mesh``). Stage ``s`` owns layers ``[s L / S, (s + 1) L / S)``
and the prompt streams through the stages in chunks of ``chunk`` rows. The
JAX package runs a GPipe tick loop in which stage s works on chunk t - s
at tick t; here each stage is a process that takes the chunks in order:
stage 0 embeds chunk c, the others receive it from stage s - 1, run their
layers on it and send it on. Causality makes this exact: when a stage runs
layer l on chunk c, the K/V rows of chunks 0..c of that layer are in its
buffer, and its query rows at ``q_offset = c * chunk`` attend to keys
``[0, (c + 1) chunk)`` through K4 over a query block
(``flash_prefill_partial``). The raw per-key summary sums add up over the
chunks (the JAX package's inactive ticks add zero), so after the last
chunk each stage finalizes them and fills its own layers' caches. Every
stage then broadcasts its layers' caches to every rank (the counterpart of
the ``P('pp')`` out-spec reassembling them), and the last stage the final
hidden row, from which every rank forms the logits. Decode then runs on
each rank through the single-card path, which needs every layer: each rank
holds the whole model, as the JAX package's decode holds the whole
parameter tree.

A chunk's rows are above the decode kernels' row limit, so a quantized
projection there dequantizes to bf16 and multiplies, as the single-card
prefill does; each stage dequantizes its layers once per prefill and keeps
the copies until it ends, rather than once per chunk.

As in the JAX package (whose docstring says so), PP spreads the layers'
work over cards and is not there for speed: at 64-row chunks the matmuls
are small, and batch-1 decode gains nothing from it.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..caches import get_cache_strategy, get_prompt_compressor, strategy_needs_attn
from ..models.transformer import _block, _embed, _linear, _logits, _qkv, fill_from_kv, rms_norm
from ..ops.attention import _plen, finalize_summary
from ..ops.linear import KERNEL_MAX_ROWS, DenseLinear, Int8Linear, QuantizedLinear
from ..ops.prefill_attn import flash_prefill_partial
from ..runtime import trace


def _stage_layer(layer, dtype, dequantize: bool):
    """The projections of ``layer`` as a chunk runs them: quantized ones
    dequantized once to ``dtype`` when a chunk's rows exceed the decode
    kernels' limit (as every prefill call would dequantize them)."""

    def lin(m):
        if dequantize and isinstance(m, (QuantizedLinear, Int8Linear)):
            return DenseLinear(m.dense(dtype), m.bias)
        return m

    return SimpleNamespace(
        attention=SimpleNamespace(wqkv=lin(layer.attention.wqkv), wo=lin(layer.attention.wo)),
        feed_forward=SimpleNamespace(w13=lin(layer.feed_forward.w13),
                                     w2=lin(layer.feed_forward.w2)),
        attention_norm=layer.attention_norm, ffn_norm=layer.ffn_norm)


def pp_prefill(model, caches, tokens: torch.Tensor, prompt_len, chunk: int = 64,
               obs_len: int = 16):
    """Pipeline-parallel prefill on the rank's ``model.pp`` stage (every
    stage calls it with the same ``tokens`` [B, P]). Fills every layer's
    cache in place on every rank; returns the last-position logits [B,
    vocab] f32."""
    ctx = model.pp
    cfg = model.cfg
    B, P = tokens.shape
    S, NL = ctx.pp, cfg.n_layer
    if NL % S:
        raise ValueError(f"n_layer {NL} % pp {S} != 0")
    if P % chunk:
        raise ValueError(f"bucket {P} % chunk {chunk} != 0")
    spec = caches[0].spec
    if any(c.spec != spec for c in caches):
        raise ValueError("pp_prefill wants the stacked cache layout (homogeneous per-layer "
                         "cache specs)")
    strategy = get_cache_strategy(spec.cache_strategy)
    compressor = get_prompt_compressor(spec.prompt_compression_strategy)
    if hasattr(strategy, "profile_prefill_with_attn"):
        raise ValueError("hybrid profiling needs full attention maps; use sp or single-device")
    need_summary = strategy_needs_attn(strategy, spec) or (
        spec.max_cache_length < P and compressor.needs_attn)

    dev = tokens.device
    Lloc, NC = NL // S, P // chunk
    first = ctx.rank * Lloc
    input_pos = torch.arange(P, dtype=torch.int32, device=dev)
    plen = _plen(prompt_len, B, dev)
    valid = input_pos[None, :] < plen[:, None]
    dtype = model.tok_embeddings.dtype
    layers = [_stage_layer(model.layers[first + i], dtype, B * chunk > KERNEL_MAX_ROWS)
              for i in range(Lloc)]
    KVH, hd = cfg.n_kv_head, cfg.head_dim
    kbuf = torch.zeros((Lloc, B, KVH, P, hd), dtype=dtype, device=dev)
    vbuf = torch.zeros_like(kbuf)
    cum = torch.zeros((Lloc, B, KVH, P), dtype=torch.float32, device=dev)
    obs = torch.zeros_like(cum)
    x_last = torch.zeros((B, cfg.dim), dtype=torch.float32, device=dev)
    hop = torch.empty((B, chunk, cfg.dim), dtype=dtype, device=dev)
    for c in range(NC):
        off, end = c * chunk, (c + 1) * chunk
        x = _embed(model, tokens[:, off:end]) if ctx.rank == 0 else ctx.recv_prev(hop)
        freqs = model.rope[off:end]
        for li, layer in enumerate(layers):
            q, k, v = _qkv(cfg, layer.attention,
                           rms_norm(x, layer.attention_norm, cfg.norm_eps), freqs, prefill=True)
            kbuf[li, :, :, off:end] = k
            vbuf[li, :, :, off:end] = v
            with trace.span("prefill.attn", device=True):
                y, cum_p, obs_p = flash_prefill_partial(
                    q, kbuf[li, :, :, :end], vbuf[li, :, :, :end], plen, q_offset=off,
                    need_summary=need_summary, obs_len=obs_len)
            if need_summary:
                cum[li, :, :, :end] += cum_p
                obs[li, :, :, :end] += obs_p
            y = y.transpose(1, 2).reshape(B, chunk, cfg.n_head * hd)
            x = _block(cfg, layer, x, _linear(True, layer.attention.wo, y), prefill=True)
        if ctx.rank < S - 1:
            ctx.send_next(x)
            continue
        row = (plen - 1 - off).long()  # the final hidden row, in its chunk
        own = (row >= 0) & (row < chunk)
        picked = x[torch.arange(B, device=dev), row.clamp(0, chunk - 1)].float()
        x_last = torch.where(own[:, None], picked, x_last)
    ctx.flush()
    del layers

    for li in range(Lloc):
        summary = (finalize_summary(cum[li], obs[li], plen, P, obs_len)
                   if need_summary else None)
        fill_from_kv(strategy, compressor, caches[first + li], kbuf[li], vbuf[li], summary,
                     input_pos, valid, prompt_len)
    del kbuf, vbuf, cum, obs
    for layer, cache in enumerate(caches):
        for t in cache.tensors():
            ctx.broadcast(t, layer // Lloc)
    ctx.broadcast(x_last, S - 1)
    return _logits(model, x_last.to(dtype)[:, None], prefill=True)[:, 0]
