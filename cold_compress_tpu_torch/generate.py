"""Single-prompt generation CLI of the port.

Counterpart of the repository's ``generate.py`` (the JAX package's CLI),
with the same flags, the same prompt-file lookup in ``./prompts``, the same
truncation of an over-long prompt and the same output sections
(GENERATION, PERFORMANCE, DETAILED PERFORMANCE, KV CACHE STATISTICS). It
runs on the card unless ``--device cpu`` is given:

    python -m cold_compress_tpu_torch.generate \\
        --checkpoint_path ckpt/byte/Meta-Llama-3-8B-Instruct/model_int4.g128.npz \\
        --cache_config heavy_hitter_pyramid --max_cache_length 0.25 --cache_bits 8
    python -m cold_compress_tpu_torch.generate --device cpu --random_weights TestKernel \\
        --max_new_tokens 16 --cache_strategy heavy_hitter \\
        --prompt_compression_strategy heavy_hitter --max_cache_length 0.25

The checkpoint is a ``.npz`` in the flat key scheme (``python -m
cold_compress_tpu_torch.quantize`` writes one); its parent directory names
the architecture, and a path containing ``byte`` selects the byte-level
tokenizer, which needs no tokenizer file. ``--random_weights <model>`` runs
``init_params`` weights (seed 0, bf16) with the byte tokenizer.
On the card, decode replays a captured CUDA graph of one step.
``--attn_i8dot {auto,on,off}`` picks decode attention's branch over a
quantized cache (auto: the JAX program's default on a TPU).
``--profile PATH`` writes a ``torch.profiler`` trace of the run, the
program's spans (``runtime/trace.py``) among its ranges;
``--compile`` is accepted and does nothing. ``run(args)`` returns
``(sequence, info, caches)`` for programs that drive the CLI.

``--tp N`` runs N ranks, each with its shard of the weights, caches and
heads (``parallel/``; with or without ``--tp_kernels``, which the JAX
package needs to keep its kernels under tensor parallelism and the port
always does), one card per rank over NCCL (``--device cpu``: gloo ranks on
the CPU); rank 0 prints. ``--sp N`` splits the prompt's query rows over N
ranks (with ``--tp M``, N x M ranks over dense weights), ``--pp N`` the
layers of the prefill over N stages; each such rank then decodes on its
own (sp x tp: over its tp group). Under ``torchrun`` the processes it
started are the ranks.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from .device import resolve_device
from .models.config import ModelConfig
from .models.transformer import init_caches, init_params, model_size_bytes
from .runtime.engine import (
    build_cache_specs,
    build_model,
    cache_compatibility,
    compute_max_seq_length,
    load_model,
)
from .runtime import trace
from .runtime.generate import bucket_length, generate
from .runtime.stats import get_cache_stats, print_stats
from .tokenizer import encode, get_tokenizer
from .utils.cli import (
    ATTN_I8DOT,
    add_cache_arguments,
    add_generation_arguments,
    merge_cache_config,
    validate_parallel,
)

PROMPTS_DIR = Path(__file__).resolve().parents[1] / "prompts"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run simple single-prompt generation (for development and debugging "
        "purposes)."
    )
    parser.add_argument("--prompt", type=str, default="long_prompt_short_output.txt",
                        help="Input prompt; *.txt loads from ./prompts.")
    parser.add_argument("--max_new_tokens", type=int, default=512, help="Max new tokens.")
    parser.add_argument("--cache_config", type=str, default=None,
                        help="Name of a YAML file in ./cache_configs.")
    parser.add_argument("--random_weights", type=str, default=None,
                        help="Skip checkpoint loading: run the named architecture with random "
                        "weights and a byte tokenizer.")
    add_generation_arguments(parser)
    add_cache_arguments(parser)
    return parser


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parsed flags with the cache config overlaid and a ``*.txt`` prompt
    read from ``./prompts``; layouts the JAX package refuses and
    incompatible options raise."""
    args = merge_cache_config(build_parser().parse_args(argv))
    if args.prompt.endswith(".txt"):
        args.prompt = (PROMPTS_DIR / args.prompt).read_text().strip()
    validate_parallel(args)
    if args.dp > 1:
        raise ValueError(f"--dp {args.dp}: data parallelism shards batch lanes; generate runs "
                         "one prompt (eval --batch_size takes --dp)")
    cache_compatibility(vars(args))
    return args


def run(args: argparse.Namespace, next_tokens: Optional[List[int]] = None, ctx=None):
    """Load, build and generate; returns ``(sequence, info, caches)``.
    ``info`` is ``generate()``'s, plus ``generation`` (the decoded new
    text), ``model_size_bytes`` and ``load_seconds``. ``next_tokens``
    teacher-forces the generated tokens (for comparisons). With ``ctx``
    (inside a rank of ``parallel/launch.py``) the model is the rank's
    (``parallel/tp_decode.py::build_rank_model``): its tensor-parallel
    shard, whose caches hold its KV heads, or a sequence- or
    pipeline-parallel rank's."""
    device = ctx.device if ctx is not None else resolve_device(args.device)
    path = str(args.checkpoint_path).lower()
    is_chat = "chat" in path or "instruct" in path

    t0 = time.time()
    if args.random_weights:
        cfg = ModelConfig.from_name(args.random_weights)
        params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                             torch.bfloat16, device)
        tokenizer = get_tokenizer(None, "byte")
    else:
        checkpoint_path = Path(args.checkpoint_path)
        if not checkpoint_path.is_file():
            raise FileNotFoundError(checkpoint_path)
        cfg, params = load_model(checkpoint_path, model_name=args.model_name, device=device)
        tokenizer_path = checkpoint_path.parent / "tokenizer.model"
        if not tokenizer_path.is_file():
            tokenizer_path = checkpoint_path.parent
        tokenizer = get_tokenizer(tokenizer_path, checkpoint_path, is_chat=is_chat)
    load_seconds = time.time() - t0
    print(f"Time to load model: {load_seconds:.02f} seconds")

    prompt_ids = encode(tokenizer, args.prompt, is_chat=is_chat)
    terminator_ids = tokenizer.get_terminator_ids()
    model_size = model_size_bytes(params)
    print(f"{model_size / 1e9:.02f} GB of (non-embedding) parameters.")

    max_prompt_length, max_seq_length = compute_max_seq_length(
        cfg, [len(prompt_ids)], args.max_new_tokens)
    if len(prompt_ids) >= max_seq_length:
        # Keep room for at least one generated token.
        keep = max_seq_length - min(args.max_new_tokens, max_seq_length // 2)
        print(f"WARNING: prompt ({len(prompt_ids)} tokens) exceeds the model context "
              f"({cfg.block_size}); truncating to {keep} tokens.")
        prompt_ids = prompt_ids[:keep]
        max_prompt_length = keep
    max_new_tokens = min(args.max_new_tokens, max_seq_length - max_prompt_length)

    token_ids = None
    if "hybrid" in args.cache_strategy:
        token_ids = {"special": tokenizer.special_ids(),
                     "punctuation": tokenizer.punctuation_ids()}
    specs = build_cache_specs(cfg, vars(args), max_seq_length, token_ids=token_ids)
    # Rope rows for the prefill bucket (a power of two) and every decode step.
    build_kw = dict(max_positions=bucket_length(max_seq_length),
                    attn_i8dot=ATTN_I8DOT[getattr(args, "attn_i8dot", "auto")])
    if ctx is None:
        model = build_model(cfg, params, device, **build_kw)
    else:
        from .parallel.tp_decode import build_rank_model

        model = build_rank_model(cfg, params, ctx, **build_kw)
    del params
    caches = init_caches(model.cfg, specs, 1, torch.bfloat16, device=device)

    out = args.profile if ctx is None or ctx.rank == 0 else None  # rank 0 writes files
    with trace.profiled(bool(out), device.type == "cuda") as prof:
        seq, info, caches = generate(
            model, caches, prompt_ids, max_new_tokens, next_tokens=next_tokens,
            terminator_ids=terminator_ids, attn_top_k=args.attn_top_k,
            feed_long_prompts=args.feed_long_prompts,
        )
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out))
        print(f"Profile written to {out}")

    info["generation"] = tokenizer.decode(seq[info["prompt_length"]:])
    info["model_size_bytes"] = model_size
    info["load_seconds"] = load_seconds
    return seq, info, caches


def report(seq, info, caches) -> dict:
    """What ``main`` prints of a run: ``info`` without its arrays, and the
    cache statistics."""
    keep = {k: v for k, v in info.items() if k != "final_probs"}
    return {"info": keep, "cache_stats": get_cache_stats(caches, info["prompt_length"],
                                                         info["num_generated"])}


def _rank_report(ctx, args) -> dict:
    """One rank of ``--tp``, ``--sp`` or ``--pp``: its run's report."""
    return report(*run(args, ctx=ctx))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.tp * args.sp * args.pp > 1:
        from .parallel.launch import launch

        out = launch(_rank_report, args, tp=args.tp, sp=args.sp, pp=args.pp,
                     device=args.device)[0]
        if out is None:  # a rank other than 0 under torchrun
            return 0
    else:
        out = report(*run(args))
    info = out["info"]
    perf_stats = info["perf_stats"]
    print("\n==========\n")
    print("GENERATION:")
    print(info["generation"])
    print("\n==========\n")
    print("PERFORMANCE:")
    tokens_per_second = perf_stats["total_toks_per_sec"]
    print(f"Time: {perf_stats['total_seconds']:.02f} sec total, "
          f"{tokens_per_second:.02f} tokens/sec, {perf_stats['decode_tokens']} tokens")
    print(f"Bandwidth: {info['model_size_bytes'] * tokens_per_second / 1e9:.02f} GB/s")
    print(f"Memory used: {perf_stats['memory_used_gb']:.02f} GB")
    print("\n==========\n")
    print("DETAILED PERFORMANCE:")
    print_stats(perf_stats)
    print("\n==========\n")
    print("KV CACHE STATISTICS:")
    print_stats(out["cache_stats"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
