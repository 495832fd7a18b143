"""CLI argument groups and the cache-config YAML overlay.

Port of ``cold_compress_tpu/utils/cli.py`` (a copy: the port imports
nothing of the JAX package): the same cache and generation flags, so that
``cache_configs/*.yaml`` and the JAX package's command lines work unchanged.
The overlay reads YAML with PyYAML, as the JAX package does, imported
where a file is read (a missing PyYAML raises there). ``--device`` defaults
to the card. The parallelism flags are accepted for parity, and
``refuse_unported`` raises on any that asks for more than one device: they
are not ported yet.
"""

from __future__ import annotations

import argparse
from pathlib import Path

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

NOT_PORTED_PARALLEL = "is not ported yet (ROADMAP: Parallelism)"

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
                       help=f"Tensor-parallel degree; only 1 (more {NOT_PORTED_PARALLEL}).")
    group.add_argument("--tp_kernels", action="store_true",
                       help=f"Explicit tensor parallelism with per-device kernels; "
                       f"{NOT_PORTED_PARALLEL}.")
    group.add_argument("--pp", type=int, default=1,
                       help=f"Pipeline-parallel prefill degree; only 1 (more {NOT_PORTED_PARALLEL}).")
    group.add_argument("--sp", type=int, default=1,
                       help=f"Sequence-parallel prefill degree; only 1 (more {NOT_PORTED_PARALLEL}).")
    group.add_argument("--dp", type=int, default=1,
                       help=f"Data-parallel degree; only 1 (more {NOT_PORTED_PARALLEL}).")


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise on any parallelism flag that asks for more than one device."""
    for flag in ("tp", "sp", "pp", "dp"):
        if getattr(args, flag, 1) > 1:
            raise ValueError(f"--{flag} {getattr(args, flag)} {NOT_PORTED_PARALLEL}")
    if getattr(args, "tp_kernels", False):
        raise ValueError(f"--tp_kernels {NOT_PORTED_PARALLEL}")


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
