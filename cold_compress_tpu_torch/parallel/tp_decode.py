"""Tensor-parallel prefill and decode with per-rank kernels.

Counterpart of ``cold_compress_tpu/parallel/tp_decode.py`` (its
``shard_map`` run mode, ``--tp_kernels``): each rank holds its own shard of
the weights, repacked once into the single-card kernels' layouts, and runs
the same kernels as the single-card path (K1 for the projections, K2 for
the vocab head, decode attention and eviction over its own KV heads, flash
prefill over its own heads). The only communication is the reference's
tp.py scheme: column-parallel wq/wk/wv/w1/w3, row-parallel wo/w2 with one
all-reduce after each, and a vocab-sharded head whose logits are gathered
(``mesh.TpContext``). The model (``models/transformer.py``) holds the
rank's ``TpContext`` and runs those collectives; ``runtime/generate.py``
runs prefill and the decode loop unchanged over it.

Shards come from the storage layouts (``runtime/engine.py::params_from_flat``:
dense ``[in, out]`` tensors, int4 rowpack ``{"w", "scales", "zeros",
"group_size"}``, int8 ``{"kind": "int8", "w", "scales"}``), and are fused
only afterwards: a global q|k|v or w1|w3 fuse would pair columns across
shard boundaries. Row-parallel int4 leaves are unpacked before their input
rows are sliced (rowpack pairs rows r and r + IN/2 in one byte), then
repacked.

Numerics against tp = 1: the column-parallel projections are the same math
(each activation row is whole); row-parallel W4A8 quantizes activations
per local input segment, as the JAX package's tp does, so both sit within
the activation-quantization scale of the single-card run.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.config import ModelConfig
from ..ops.qmm import unpack_rowpack
from ..quantization.weight_quant import pack_int4
from .mesh import TpContext, validate_tp

#: Column-parallel leaves; every other projection (wo, w2) is row-parallel.
_COL = ("wq", "wk", "wv", "w1", "w3", "bq", "bk", "bv")


def _own(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy: a shard must not keep the whole leaf alive."""
    return x.clone(memory_format=torch.contiguous_format)


def _part(n: int, tp: int, what: str) -> int:
    if n % tp:
        raise ValueError(f"{what} {n} must divide tp={tp}")
    return n // tp


def _slice_last(a: torch.Tensor, t: int, tp: int) -> torch.Tensor:
    s = _part(a.shape[-1], tp, "output dim")
    return _own(a[..., t * s:(t + 1) * s])


def _col_local(leaf, t: int, tp: int):
    """Column-parallel shard: the output axis sliced. Every storage layout
    ends in the output axis (int4 bytes, scales and zeros; int8 bytes and
    per-column scales; a dense weight or a bias), and int4 rowpack pairs
    rows, not columns, so each part is sliced as it is."""
    if leaf is None:
        return None
    if isinstance(leaf, dict):
        return {k: _slice_last(v, t, tp) if isinstance(v, torch.Tensor) else v
                for k, v in leaf.items()}
    return _slice_last(leaf, t, tp)


def _row_local(leaf, t: int, tp: int):
    """Row-parallel shard: the input axis sliced. int4 is unpacked first
    (rowpack's packed input axis would split nibble pairs), sliced with its
    scale groups, and packed again; int8's per-column scales stay whole."""
    if leaf is None:
        return None
    if isinstance(leaf, dict) and leaf.get("kind") == "int8":
        s = _part(leaf["w"].shape[-2], tp, "input dim")
        return {**leaf, "w": _own(leaf["w"][..., t * s:(t + 1) * s, :])}
    if isinstance(leaf, dict):
        q = unpack_rowpack(leaf["w"])  # [IN, OUT] nibbles
        s = _part(q.shape[0], tp, "input dim")
        gs = leaf["group_size"]
        if s % gs:
            raise ValueError(
                f"per-shard input rows ({s}) must align to quantization groups ({gs}); "
                "lower tp or the group size")
        g = s // gs
        return {**leaf, "w": pack_int4(q[t * s:(t + 1) * s]),
                "scales": _own(leaf["scales"][t * g:(t + 1) * g]),
                "zeros": _own(leaf["zeros"][t * g:(t + 1) * g])}
    s = _part(leaf.shape[-2], tp, "input dim")
    return _own(leaf[..., t * s:(t + 1) * s, :])


def _head_local(out_w, t: int, tp: int):
    """Vocab-sharded head: the output (vocab) axis sliced, each shard then
    repacked into the single-card head's layout by ``make_linear``."""
    return _col_local(out_w, t, tp)


def prepare_tp(cfg: ModelConfig, params: Dict[str, Any], tp: int, t: int) -> Dict[str, Any]:
    """Rank ``t``'s shard of a parameter tree in the storage layouts,
    unfused: column-parallel wq/wk/wv/w1/w3 (and biases), row-parallel
    wo/w2, the vocab-sharded head; embeddings and norms whole. Building the
    model from it (``build_tp_model``) fuses and repacks the shard."""
    validate_tp(cfg, tp)
    if any("wqkv" in lp["attn"] or "w13" in lp["ffn"] for lp in params["layers"]):
        raise ValueError(
            "prepare_tp shards per-projection weights; do not fuse_layer_params before it "
            "(fused q|k|v pairs columns across shard boundaries)")

    def shard(group):
        return {k: _col_local(v, t, tp) if k in _COL else _row_local(v, t, tp)
                for k, v in group.items()}

    layers = [{"attn": shard(lp["attn"]), "ffn": shard(lp["ffn"]),
               "attention_norm": lp["attention_norm"], "ffn_norm": lp["ffn_norm"]}
              for lp in params["layers"]]
    return {"tok_embeddings": params["tok_embeddings"], "norm": params["norm"],
            "layers": layers, "output": _head_local(params["output"], t, tp)}


def local_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The per-rank config: heads and width divided by tp (the reference's
    TP config division, tp.py:163-168); head_dim, derived, is unchanged."""
    return cfg.replace(n_head=cfg.n_head // tp, n_kv_head=cfg.n_kv_head // tp,
                       dim=cfg.dim // tp)


def build_tp_model(cfg: ModelConfig, params: Dict[str, Any], ctx: TpContext,
                   max_positions: Optional[int] = None, **build_kw):
    """The rank's model: its shard of ``params`` (whole, storage layouts, on
    any device) built on ``ctx.device`` with ``runtime/engine.py::build_model``
    (fused, repacked) over the local config, holding ``ctx`` as ``model.tp``
    (at tp = 1 too, for its dp layout). ``build_kw`` are ``build_model``'s
    options."""
    from ..runtime.engine import build_model

    local = tree_to(prepare_tp(cfg, params, ctx.tp, ctx.t), ctx.device)
    model = build_model(local_cfg(cfg, ctx.tp), local, ctx.device, max_positions=max_positions,
                        **build_kw)
    model.tp = ctx
    return model


def _has_quantized_leaf(params: Dict[str, Any]) -> bool:
    """Whether a storage-layout tree holds an int4 or int8 leaf (a dict)."""
    leaves = [params["output"]] + [leaf for lp in params["layers"]
                                   for group in ("attn", "ffn") for leaf in lp[group].values()]
    return any(isinstance(leaf, dict) for leaf in leaves)


def build_rank_model(cfg: ModelConfig, params: Dict[str, Any], ctx,
                     max_positions: Optional[int] = None, **build_kw):
    """The rank's model under any layout (``mesh.make_context``): its tp
    shard for a ``TpContext``; under an ``SpContext`` the whole model (or,
    at tp > 1, the shard of its replica's tp group: dense weights only, as
    the JAX package's ``--sp`` with ``--tp``) holding it as ``model.sp``;
    under a ``PpContext`` the whole model holding it as ``model.pp``."""
    from ..runtime.engine import build_model
    from .mesh import SpContext

    if cfg.n_experts or cfg.layer_types is not None:
        raise ValueError(f"{cfg.name}: experts and sliding-window layers run on one card "
                         "(the parallel layouts' prefills and shards take neither)")
    if isinstance(ctx, TpContext):
        return build_tp_model(cfg, params, ctx, max_positions, **build_kw)
    if isinstance(ctx, SpContext) and ctx.tp > 1:
        if _has_quantized_leaf(params):
            raise ValueError("--sp with --tp requires dense (bf16) weights")
        model = build_tp_model(cfg, params, ctx.tp_ctx, max_positions, **build_kw)
    else:
        model = build_model(cfg, tree_to(params, ctx.device), ctx.device,
                            max_positions=max_positions, **build_kw)
    if isinstance(ctx, SpContext):
        model.sp = ctx
    else:
        model.pp = ctx
    return model


def tree_to(node, device):
    """A parameter tree with every tensor on ``device``."""
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, dict):
        return {k: tree_to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_to(v, device) for v in node]
    return node


def rank_generate(ctx: TpContext, cfg: ModelConfig, params, cache_kw: Dict[str, Any],
                  prompts, max_new_tokens: int, *, max_seq_length: int,
                  dtype: torch.dtype = torch.bfloat16, batch: bool = False,
                  build_kw: Optional[Dict[str, Any]] = None, **generate_kw):
    """One rank's ``generate`` (``batch``: ``generate_batch``) on its
    model under ``ctx``'s layout (``build_rank_model``), for
    ``parallel/launch.py``: ``params`` a parameter tree in the storage
    layouts or a flat checkpoint dict (``runtime/engine.py::params_from_flat``),
    caches from ``cache_kw`` at ``max_seq_length`` for the rank's KV heads and
    lanes. Returns ``(sequence(s), info)``."""
    from ..models.transformer import init_caches
    from ..runtime.engine import build_cache_specs, params_from_flat
    from ..runtime.generate import generate, generate_batch

    if "layers" not in params:
        params = params_from_flat(params, ctx.device)
    model = build_rank_model(cfg, params, ctx, **(build_kw or {}))
    del params
    specs = build_cache_specs(cfg, cache_kw, max_seq_length)
    lanes = len(prompts) // getattr(ctx, "dp", 1) if batch else 1
    caches = init_caches(model.cfg, specs, lanes, dtype, device=ctx.device)
    run = generate_batch if batch else generate
    seq, info, _ = run(model, caches, prompts, max_new_tokens, **generate_kw)
    return seq, info
