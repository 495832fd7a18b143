"""CLI argument groups and the cache-config YAML overlay.

Port of ``cold_compress_tpu/utils/cli.py`` (a copy: the port imports
nothing of the JAX package): the same cache and generation flags, so that
``cache_configs/*.yaml`` and the JAX package's command lines work unchanged.
The overlay reads YAML with PyYAML, as the JAX package does, imported
where a file is read (a missing PyYAML raises there). ``--device`` defaults
to the card. ``--tp``, ``--tp_kernels``, ``--dp``, ``--sp`` and ``--pp``
run ranks of the port's tensor, data, sequence and pipeline parallelism
(``parallel/``); ``validate_parallel`` raises the JAX package's refusals of
the combinations it does not take.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..models.config import ModelConfig

CACHE_STRATEGIES = [
    "full",
    "random",
    "recent_global",
    "heavy_hitter",
    "l2",
    "hybrid",
    "keep_it_odd",
]
ALL_STRATEGIES = CACHE_STRATEGIES + [f"debug_{s}" for s in CACHE_STRATEGIES]

#: The repository's cache configs (``--cache_config <name>``).
CACHE_CONFIG_DIR = Path(__file__).resolve().parents[2] / "cache_configs"

#: ``--attn_i8dot`` choices and the ``set_attn_i8dot`` mode each stands for.
ATTN_I8DOT = {"auto": "auto", "on": True, "off": False}
ATTN_I8DOT_HELP = (
    "Decode attention's branch over a quantized cache: auto (default) as the JAX program "
    "on a TPU, int8 queries and probabilities on the int8 tensor cores for an int8 cache "
    "where its kernel runs, dequantized K/V elsewhere; on: the int8 branch at every "
    "quantized cache; off: dequantized K/V everywhere.")


def add_cache_arguments(parser: argparse.ArgumentParser):
    group = parser.add_argument_group("cache_args")
    group.add_argument(
        "--max_cache_length", type=float, default=[1.0], nargs="+",
        help="Cache size per layer: fraction of max seq length if <= 1, else "
        "absolute. Tiled/extended across layers per --cache_length_pattern.",
    )
    group.add_argument(
        "--cache_bits", default=None, type=int, choices=[2, 4, 8],
        help="Quantize the KV cache to this many bits.",
    )
    group.add_argument(
        "--cache_length_pattern", default="tile", choices=["tile", "repeat", "funnel", "pyramid"],
    )
    group.add_argument("--cache_strategy", default=["full"], nargs="+", choices=ALL_STRATEGIES)
    group.add_argument(
        "--cache_strategy_pattern", default="tile", choices=["tile", "repeat"],
        help="How to apply the cache_strategy across layers.",
    )
    parser.add_argument(
        "--feed_long_prompts", default=False, action="store_true",
        help="If True and |prompt| > max_cache_length, prefill with "
        "prompt[:budget] and feed the rest token-by-token.",
    )
    group.add_argument(
        "--prompt_compression_strategy", default=["recent_global"], nargs="+",
        help="Strategy for compressing a prompt that exceeds the cache budget.",
    )
    group.add_argument(
        "--global_tokens", default=1, type=int,
        help="Number of initial (attention-sink) tokens always kept.",
    )
    group.add_argument(
        "--recent_window", default=10, type=float,
        help="Recently generated tokens spared from eviction (fraction of budget if < 1).",
    )
    group.add_argument(
        "--history_window_size", default=1, type=int,
        help="Attention-history window for heavy-hitter scoring (1 = unbounded accumulation).",
    )
    group.add_argument(
        "--attn_thresholding", default=False, action="store_true",
        help="Record binary (attention >= uniform) indicators instead of raw probabilities.",
    )
    parser.add_argument(
        "--hybrid_strategies", default=None,
        help="Hybrid (FastGen) strategy menu; set via a cache_config YAML.",
    )
    parser.add_argument(
        "--min_recovery_frac", default=0.9, type=float,
        help="Minimum recovered attention fraction for hybrid (FastGen) profiling.",
    )


def add_generation_arguments(parser: argparse.ArgumentParser):
    group = parser.add_argument_group("generation_args")
    group.add_argument(
        "--checkpoint_path", type=Path,
        default=Path("checkpoints/meta-llama/Meta-Llama-3-8B-Instruct/model.npz"),
        help="Model checkpoint path (.npz in the flat key scheme, e.g. from the quantize CLI).",
    )
    group.add_argument(
        "--model_name", type=str, default=None,
        help="Override architecture name (default: checkpoint parent dir).",
    )
    group.add_argument("--profile", type=Path, default=None,
                       help="Write a torch.profiler trace (Chrome format) of the run to this path.")
    group.add_argument(
        "--compile", action="store_true",
        help="Accepted for parity with the JAX package's CLI; does nothing here "
        "(the port runs eagerly, with hand-written CUDA kernels).",
    )
    group.add_argument("--device", type=str, default="cuda",
                       help="cuda (default; raises without a card) | cpu")
    group.add_argument(
        "--attn_top_k", type=float, default=1.0,
        help="Fraction of top-K attentions over which to aggregate values during decode.",
    )
    group.add_argument("--attn_i8dot", default="auto", choices=list(ATTN_I8DOT),
                       help=ATTN_I8DOT_HELP)
    group.add_argument("--tp", type=int, default=1,
                       help="Tensor-parallel degree: ranks (one card each) holding a shard of "
                       "the heads, FFN columns and vocabulary, each running the single-card "
                       "kernels on it.")
    group.add_argument("--tp_kernels", action="store_true",
                       help="Explicit tensor parallelism with per-device kernels; the port's "
                       "--tp always runs its kernels per rank, so this changes nothing.")
    group.add_argument("--pp", type=int, default=1,
                       help="Pipeline-parallel prefill degree: ranks each running a stage of "
                       "the layers over the prompt in 64-token chunks, then decoding on the "
                       "whole model. Runs alone.")
    group.add_argument("--sp", type=int, default=1,
                       help="Sequence-parallel prefill degree: ranks each attending the "
                       "prompt's query rows of one contiguous block; with --tp N (dense "
                       "weights) a 2-D sp x tp layout.")
    group.add_argument("--dp", type=int, default=1,
                       help="Data-parallel degree: batch lanes split over dp replicas of the "
                       "(tensor-parallel) model.")


def validate_parallel(args: argparse.Namespace) -> None:
    """Raise the JAX package's refusals of a parallel layout, before
    anything is loaded: a degree below 1; ``--pp`` with ``--tp``/``--sp``/
    ``--dp``; ``--sp`` with ``--dp``; ``--sp`` with ``--tp_kernels`` (the
    JAX package's sp x tp runs under GSPMD); a ``--pp`` that does not divide
    the named model's layers; a ``--tp`` that does not divide its heads
    (``parallel/mesh.py::validate_tp``). (``--sp`` with ``--tp`` over
    quantized weights raises once they are loaded.)"""
    from ..parallel.mesh import Layout, validate_tp

    sp, tp, pp = args.sp, args.tp, args.pp
    Layout(tp=tp, dp=args.dp, sp=sp, pp=pp)
    if sp > 1 and tp > 1 and args.tp_kernels:
        raise ValueError("--sp with --tp uses GSPMD; drop --tp_kernels")
    cfg = named_config(args) if tp > 1 or pp > 1 else None
    if pp > 1 and cfg.n_layer % pp:
        raise ValueError(f"n_layer {cfg.n_layer} % pp {pp} != 0")
    if tp > 1:
        validate_tp(cfg, tp)


def named_config(args: argparse.Namespace) -> ModelConfig:
    """The architecture the flags name (``--random_weights``, else
    ``--model_name``, else the checkpoint's parent directory), before
    anything is loaded."""
    return ModelConfig.from_name(getattr(args, "random_weights", None) or args.model_name
                                 or Path(args.checkpoint_path).parent.name)


def merge_cache_config(args: argparse.Namespace) -> argparse.Namespace:
    """Overlay ``cache_configs/<name>.yaml`` (or a path) onto parsed args:
    every key of the file replaces the flag of that name."""
    if not getattr(args, "cache_config", None):
        return args
    name = args.cache_config
    if not name.endswith(".yaml"):
        name += ".yaml"
    import yaml  # PyYAML, imported only where an overlay is read

    for path in (Path(name), CACHE_CONFIG_DIR / name):
        if path.exists():
            overlay = yaml.safe_load(path.read_text())
            return argparse.Namespace(**{**vars(args), **overlay})
    raise FileNotFoundError(f"Cache config not found: {name}")
