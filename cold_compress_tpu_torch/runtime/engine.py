"""Engine utilities: per-layer cache specs, compatibility checks, and
checkpoint IO in the JAX package's format.

Counterpart of ``cold_compress_tpu/runtime/engine.py``. Checkpoints are a
flat ``.npz``: ``a/b/c`` key paths, ``#bf16`` for bf16 arrays stored as
uint16 views, ``#none`` for absent leaves, and a quantized weight as the
keys ``w``, ``scales`` and ``qmeta = [bits, group_size]`` under its path
(int4 weights also ``zeros``; ``qmeta`` bits 8 marks an int8 weight with
per-column scales). ``save_params`` writes that scheme and
``params_from_flat``/``load_params`` read it, so files pass both ways
between the two packages; ``build_model`` turns a tree into a
``Transformer``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..caches import CacheSpec, get_cache_strategy
from ..caches.patterns import apply_pattern, normalize_cache_length
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import (
    Transformer,
    fuse_layer_params,
    make_rope_table,
    set_attn_i8dot,
    set_prefill_w4a8,
)


def cache_compatibility(args: Dict[str, Any]) -> None:
    """Startup validation of strategy / compressor / length combinations."""
    for length, cache_strat, prompt_strat in zip(
        args["max_cache_length"], args["cache_strategy"],
        args["prompt_compression_strategy"],
    ):
        if cache_strat == "heavy_hitter" and prompt_strat != "heavy_hitter":
            raise ValueError(
                "Heavy Hitter cache strategy must be run with "
                "--prompt_compression_strategy heavy_hitter to return attention."
            )
        if cache_strat in {"full", "hybrid"} and length != 1.0:
            raise ValueError(
                f"{cache_strat} cache strategy only supports max_cache_length=1.0."
            )


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def build_cache_specs(cfg: ModelConfig, cache_kwargs: Dict[str, Any],
                      max_seq_length: int, token_ids: Optional[Dict[str, Any]] = None
                      ) -> Tuple[CacheSpec, ...]:
    """Normalise lengths and strategies across layers and build one spec per
    layer: fraction -> absolute lengths, tile/repeat patterns, per-layer
    recent windows and the global-token budget check. The hybrid options
    (``hybrid_strategies``, ``min_recovery_frac``) come from the cache
    options; ``token_ids`` (or ``cache_kwargs["token_ids"]``) gives the
    ``special`` id sequences and ``punctuation`` ids hybrid keeps."""
    kw = dict(cache_kwargs)
    lengths = [
        normalize_cache_length(length, max_seq_length)
        for length in _as_list(kw.get("max_cache_length", [1.0]))
    ]
    lengths = apply_pattern(lengths, cfg.n_layer, kw.get("cache_length_pattern", "tile"),
                            max_seq_length=max_seq_length)
    strategy_pattern = kw.get("cache_strategy_pattern", "tile")
    strategies = apply_pattern(
        _as_list(kw.get("cache_strategy", ["full"])), cfg.n_layer, strategy_pattern
    )
    for s in set(strategies):
        get_cache_strategy(s)  # fail fast on unknown names
    prompt_strategies = apply_pattern(
        _as_list(kw.get("prompt_compression_strategy", ["recent_global"])),
        cfg.n_layer, strategy_pattern,
    )
    recent = kw.get("recent_window", 10)
    if not isinstance(recent, (list, tuple)):
        if recent <= 1:
            recent = [max(1, int(recent * length)) for length in lengths]
        else:
            recent = [max(1, min(int(recent), length)) for length in lengths]
    global_tokens = int(kw.get("global_tokens", 1))
    if global_tokens > min(lengths):
        raise ValueError("Global tokens must be less than max_cache_length.")
    hybrid_strategies = ()
    if kw.get("hybrid_strategies"):
        from ..caches.hybrid import normalize_hybrid_strategies

        hybrid_strategies = normalize_hybrid_strategies(kw["hybrid_strategies"])
    token_ids = token_ids or kw.get("token_ids") or {}
    token_ids_special = tuple(tuple(int(t) for t in seq) for seq in token_ids.get("special", ()))
    token_ids_punc = tuple(int(t) for t in token_ids.get("punctuation", ()))
    return tuple(
        CacheSpec(
            cache_strategy=strategies[i],
            max_cache_length=int(lengths[i]),
            max_seq_length=int(max_seq_length),
            global_tokens=global_tokens,
            recent_window=int(recent[i]),
            cache_bits=kw.get("cache_bits"),
            history_window_size=int(kw.get("history_window_size", 1)),
            attn_thresholding=bool(kw.get("attn_thresholding", False)),
            prompt_compression_strategy=prompt_strategies[i],
            min_recovery_frac=float(kw.get("min_recovery_frac", 0.9)),
            hybrid_strategies=hybrid_strategies,
            token_ids_special=token_ids_special,
            token_ids_punc=token_ids_punc,
        )
        for i in range(cfg.n_layer)
    )


def min_cache_length(specs: Sequence[CacheSpec]) -> int:
    return min(s.max_cache_length for s in specs)


def compute_max_seq_length(cfg: ModelConfig, prompt_lens: Sequence[int],
                           max_new_tokens: int) -> Tuple[int, int]:
    """(longest prompt, prompt + new tokens clamped to the block size)."""
    max_prompt = max(prompt_lens)
    return max_prompt, min(max_prompt + max_new_tokens, cfg.block_size)


# --------------------------------------------------------------------------
# Checkpoint IO in the flat key scheme
# --------------------------------------------------------------------------


def _to_tensor(arr: np.ndarray, bf16: bool, device: torch.device) -> torch.Tensor:
    arr = np.require(arr, requirements=["C", "W"])  # torch wants writable memory
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_flat(flat: Dict[str, np.ndarray], device=None,
                     dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The parameter tree of the port's model from a flat checkpoint dict
    (``np.load`` of a ``save_params`` file, or ``random_quantized_params``).

    Dense leaves become tensors on ``device`` (bf16 from their uint16
    views); a quantized leaf becomes a dict ``{"w", "scales", "zeros",
    "group_size"}`` of int4 rowpack tensors, which the model repacks once
    into the W4A8 kernel's layout (``ops/qmm.py``); an int8 leaf becomes
    ``{"kind": "int8", "w", "scales", "group_size"}``. Legacy
    unsigned-nibble (uint8) packs are read as they are:
    ``ops/qmm.py::unpack_rowpack`` takes both. Layer lists are rebuilt from
    their numeric path parts. ``dtype`` casts every floating array (scales
    included) to it, as the JAX package's ``load_params(dtype=)`` does."""
    dev = resolve_device(device)
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        is_none = key.endswith("#none")
        is_bf16 = key.endswith("#bf16")
        base = key.rsplit("#", 1)[0] if (is_none or is_bf16) else key
        parts = base.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if is_none:
            node[parts[-1]] = None
        elif parts[-1] == "qmeta":
            node["qmeta"] = [int(x) for x in np.asarray(arr)]
        else:
            t = _to_tensor(np.asarray(arr), is_bf16, dev)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            node[parts[-1]] = t
    return _listify(tree)


def _listify(node):
    if isinstance(node, dict):
        if "qmeta" in node:
            bits, group_size = node["qmeta"]
            if bits == 8:
                return {"kind": "int8", "w": node["w"], "scales": node["scales"],
                        "group_size": group_size}
            if bits != 4:
                raise ValueError(f"int{bits} weights are not ported (int4 and int8 only)")
            return {
                "w": node["w"], "scales": node["scales"], "zeros": node["zeros"],
                "group_size": group_size,
            }
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [_listify(node[str(i)]) for i in range(len(keys))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def load_params(path, device=None, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """``params_from_flat`` over a ``save_params`` ``.npz`` file."""
    with np.load(path, allow_pickle=False) as data:
        return params_from_flat({k: data[k] for k in data.files}, device, dtype)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def flatten_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """A parameter tree (lists, dicts, quantized leaf dicts, tensors, None)
    in the flat key scheme; bf16 arrays as ``#bf16`` uint16 views, so numpy
    can hold them. Tensors are copied to the host one leaf at a time."""
    flat: Dict[str, np.ndarray] = {}
    if isinstance(params, dict) and "w" in params and "scales" in params:
        bits = 8 if params.get("kind") == "int8" else 4
        flat[prefix + "w"] = _array(params["w"])
        for key in ("scales", "zeros"):
            if params.get(key) is not None:
                tag = "#bf16" if params[key].dtype == torch.bfloat16 else ""
                flat[prefix + key + tag] = _array(params[key])
        flat[prefix + "qmeta"] = np.array([bits, int(params.get("group_size", 128))])
    elif isinstance(params, dict):
        for k, v in params.items():
            flat.update(flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            flat.update(flatten_params(v, f"{prefix}{i}/"))
    elif params is None:
        flat[prefix[:-1] + "#none"] = np.zeros((0,))
    else:
        tag = "#bf16" if params.dtype == torch.bfloat16 else ""
        flat[prefix[:-1] + tag] = _array(params)
    return flat


def save_params(params, path) -> None:
    """Write a parameter tree to ``path`` (``.npz``) in the flat key scheme,
    readable by the JAX package's ``load_params``."""
    flat = flatten_params(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_model(checkpoint_path, precision: Optional[torch.dtype] = torch.bfloat16,
               model_name: Optional[str] = None, device=None):
    """(cfg, params) of a checkpoint. The architecture comes from
    ``model_name`` or else the checkpoint's parent directory name; floating
    arrays are cast to ``precision``, as the JAX package's ``load_model``
    does. ``build_model`` then builds the model."""
    path = Path(checkpoint_path)
    cfg = ModelConfig.from_name(model_name or path.parent.name)
    return cfg, load_params(path, device, dtype=precision)


def build_model(cfg: ModelConfig, params: Dict[str, Any], device=None,
                max_positions: Optional[int] = None, prefill_w4a8: bool = False,
                attn_i8dot="auto") -> Transformer:
    """Fuse q/k/v and w1/w3, repack int4 leaves into the kernel layout and
    build the ``Transformer`` with a rope table for ``max_positions``.
    ``prefill_w4a8`` sends the int4 layer projections' prefill to the W4A8
    prefill kernel (K8; off by default, as in the JAX package);
    ``attn_i8dot`` is decode attention's ``i8dot`` mode
    (``models/transformer.py::set_attn_i8dot``)."""
    dev = resolve_device(device)
    rope = make_rope_table(cfg, max_positions, device=dev)
    model = Transformer(cfg, fuse_layer_params(params), rope).to(dev)
    if prefill_w4a8:
        set_prefill_w4a8(model, True)
    set_attn_i8dot(model, attn_i8dot)
    return model

