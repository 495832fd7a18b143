"""Sequence-parallel (SP) prefill over ranks, and SP x TP.

Counterpart of ``cold_compress_tpu/parallel/sp.py`` (``sp_prefill``,
``sp_tp_prefill``; the meshes are ``mesh.make_sp_tp_mesh``). SP covers
every cache strategy, as there (its ``sp_supported`` is always true). The
prompt's query rows split over the sp ranks in contiguous blocks: rank
``s`` takes rows ``[s P / sp, (s + 1) P / sp)``.
Per layer each rank:

  q, k, v = qkv(x_loc)                          its rows' projections + rope
  k_all, v_all = gather_seq(k | v)              [B, KVH, P, hd] on every rank
  y, cum_p, obs_p = flash_prefill_partial(q, k_all, v_all, q_offset=s P / sp)
  cum, obs = all_reduce(cum_p | obs_p)          exact: sums over query rows
  fill_from_kv(k_all, v_all, summary)           the same fill on every rank

``flash_prefill_partial`` is K4 over a query block at an offset (the JAX
package's ``chunked_prefill_partial``); hybrid takes K6's form
(``flash_profile_partial``), all-reduces ``cum``/``wcols`` and runs the
replicated policy pick and fill (``HybridCache.fill_after_profile``). The
attention itself is exact (each query row's softmax is independent and
sees every key), so the caches match the single card's up to the f32 order
of the summaries' sums. The last valid row's hidden state comes from the
rank that holds it, summed over sp (the other ranks add zeros).

Every rank holds the whole model (the JAX package's replicated specs), and
the caches come back the same on every rank, so decode then runs on each
rank through the single-card path with no collective (its CUDA graph
included). Under ``sp_tp_prefill`` the rank's model is its tp shard
(``tp_decode.py::build_tp_model``, dense weights only, as in the JAX
package): the two per-layer all-reduces run over its replica's tp group,
the caches come back head-sharded on tp and replicated on sp, and decode
runs through the tp path in each sp replica.

The split is the JAX package's contiguous one: at sp = 2 the second block
sees three times the causal keys of the first.
"""

from __future__ import annotations

import torch

from ..caches import get_cache_strategy, get_prompt_compressor, strategy_needs_attn
from ..caches.hybrid import _profile_windows
from ..models.transformer import _block, _embed, _linear, _logits, _qkv, fill_from_kv, rms_norm
from ..ops.attention import _plen, finalize_summary
from ..ops.linear import Int8Linear, QuantizedLinear
from ..ops.prefill_attn import flash_prefill_partial, flash_profile_partial
from ..runtime import trace


def sp_prefill(model, caches, tokens: torch.Tensor, prompt_len, obs_len: int = 16):
    """Sequence-parallel prefill on the rank's ``model.sp`` layout (every
    sp rank calls it with the same full ``tokens`` [B, P], P divisible by
    sp). Fills ``caches`` in place, the same on every rank; returns the
    last-position logits [B, vocab] f32. A model that is a tp shard runs
    ``sp_tp_prefill``'s scheme."""
    ctx = model.sp
    B, P = tokens.shape
    if P % ctx.sp:
        raise ValueError(f"prompt bucket {P} % sp {ctx.sp} != 0")
    cfg = model.cfg
    dev = tokens.device
    Ploc = P // ctx.sp
    offset = ctx.s * Ploc
    input_pos = torch.arange(P, dtype=torch.int32, device=dev)
    plen = _plen(prompt_len, B, dev)
    valid = input_pos[None, :] < plen[:, None]
    freqs = model.rope[offset:offset + Ploc]
    x = _embed(model, tokens[:, offset:offset + Ploc])
    for layer, cache in zip(model.layers, caches):
        spec = cache.spec
        strategy = get_cache_strategy(spec.cache_strategy)
        q, k, v = _qkv(cfg, layer.attention, rms_norm(x, layer.attention_norm, cfg.norm_eps),
                       freqs, prefill=True)
        k_all, v_all = ctx.gather_seq(k), ctx.gather_seq(v)
        if hasattr(strategy, "profile_prefill_with_attn"):
            _, windows = _profile_windows(spec, P)
            with trace.span("prefill.attn", device=True):
                y, cum_p, wcols_p = flash_profile_partial(q, k_all, v_all, plen, windows,
                                                          q_offset=offset)
            sums = ctx.all_reduce(torch.cat([cum_p[None], wcols_p]))
            with trace.span("prefill.cache", device=True):
                strategy.fill_after_profile(spec, cache, sums[0], sums[1:], k_all, v_all,
                                            tokens, input_pos, valid, prompt_len)
        else:
            compressor = get_prompt_compressor(spec.prompt_compression_strategy)
            need_summary = strategy_needs_attn(strategy, spec) or (
                spec.max_cache_length < P and compressor.needs_attn)
            with trace.span("prefill.attn", device=True):
                y, cum_p, obs_p = flash_prefill_partial(q, k_all, v_all, plen, q_offset=offset,
                                                        need_summary=need_summary,
                                                        obs_len=obs_len)
            summary = None
            if need_summary:
                sums = ctx.all_reduce(torch.stack([cum_p, obs_p]))
                summary = finalize_summary(sums[0], sums[1], plen, P, obs_len)
            fill_from_kv(strategy, compressor, cache, k_all, v_all, summary, input_pos, valid,
                         prompt_len)
        y = y.transpose(1, 2).reshape(B, Ploc, cfg.n_head * cfg.head_dim)
        x = _block(cfg, layer, x, _linear(True, layer.attention.wo, y), model.tp, prefill=True)
    # The last valid row: its owner contributes it, the sum over sp carries
    # it to every rank (one nonzero term per element, exact in f32).
    row = (plen - 1 - offset).long()
    own = (row >= 0) & (row < Ploc)
    x_last = torch.where(own[:, None], x[torch.arange(B, device=dev), row.clamp(0, Ploc - 1)],
                         0).float()
    x_last = ctx.all_reduce(x_last).to(x.dtype)
    return _logits(model, x_last[:, None], prefill=True)[:, 0]


def sp_tp_prefill(model, caches, tokens: torch.Tensor, prompt_len, obs_len: int = 16):
    """2-D sequence x tensor parallel prefill: query blocks over sp, heads
    and FFN columns over tp (the model is the rank's tp shard holding its
    replica's ``TpContext``). Dense weights only, as in the JAX package."""
    if any(isinstance(m, (QuantizedLinear, Int8Linear)) for m in model.modules()):
        raise ValueError("sp_tp_prefill: dense weights only (quantized runs under GSPMD tp)")
    return sp_prefill(model, caches, tokens, prompt_len, obs_len)
