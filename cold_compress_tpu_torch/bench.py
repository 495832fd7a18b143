"""Decode throughput of the port with a compressed KV cache.

Mirrors the JAX package's ``bench.py``: Llama-3-8B-class random int4
weights, a ``heavy_hitter`` cache at 25% of an 8k context by default, a
random prompt of ``context - decode_tokens - 8`` tokens from
``RandomState(0)``, one warm-up run and one measured run of ``generate``.
Prints ONE JSON line with ``bench.py``'s keys (without ``vs_baseline``,
whose 70 tok/s is the reference's A100 figure) plus the card's name and
power limit.

    python -m cold_compress_tpu_torch.bench [--strategy l2 --cache_bits 4 ...]
    python -m cold_compress_tpu_torch.bench --smoke     # TestTiny on the CPU

Served: every ``--strategy`` (``hybrid`` with ``bench.py``'s FastGen menu,
and ``debug_<strategy>``, the attention-loss analysis of ``<strategy>``),
``--cache_bits 16/8/4/2``, ``--head_bits 4/8``, any ``--context`` up to the
model's block size, ``--prefill_w4a8`` (the W4A8 prefill kernel, the
explicit counterpart of the JAX package's ``CCT_PREFILL_W4A8=1``; off by
default there too; int4 layers only), and ``--weight_bits 8/16``: int8
layers (``random_quantized_params(mode="int8")``, whose head is int8 at
either ``--head_bits``, as in the JAX package) through the W8A8 kernel, or
dense bf16 layers and head (``init_params``, seed 0) through
``torch.matmul``; ``--attn_i8dot {auto,on,off}``, decode attention's branch
over a quantized cache (``auto``, the default: the JAX program's on a TPU,
int8 queries and probabilities for the int8 cache where its kernel runs; the
JSON line names the mode); ``--batch B`` decodes B lanes through
``generate_batch``, lane b's prompt the first ``len - 8 b`` tokens of the
one prompt, all in its bucket, as ``bench.py`` does (the rate is the
aggregate over the lanes). Decode replays a captured CUDA graph of one step
on the card (the warm-up run captures it, the measured run replays it).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .utils.cli import ATTN_I8DOT, ATTN_I8DOT_HELP


def card_line() -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


#: bench.py's FastGen menu for ``--strategy hybrid``
#: (``cache_configs/fastgen.yaml``) and its synthetic token classes: the
#: bench prompt is random ids, so a few ids stand for the special and
#: punctuation tokens.
HYBRID_MENU = [
    {"strategy": "special"},
    {"strategy": "special_punc"},
    {"strategy": "special_punc_heavy_hitter", "heavy_hitter_frac": 0.3},
    {"strategy": "special_punc_heavy_hitter_window", "recent_window": 0.3,
     "heavy_hitter_frac": 0.3},
    {"strategy": "full"},
]
HYBRID_TOKEN_IDS = {"special": [[1], [2]], "punctuation": list(range(16, 48))}


def cache_kwargs(strategy: str, budget_frac: float, global_tokens: int,
                 cache_bits: Optional[int]) -> dict:
    """bench.py's cache options: ``full`` and ``hybrid`` keep the whole
    sequence (hybrid compresses by its per-head policies, with the FastGen
    menu and token classes above), the heavy-hitter cache compresses the
    prompt with SnapKV, the others (``debug_*`` included, whose shadow
    takes these options) with ``recent_global``."""
    budget = 1.0 if strategy in ("full", "hybrid") else budget_frac
    compressor = {"heavy_hitter": "heavy_hitter", "full": "full", "hybrid": "full"}.get(
        strategy, "recent_global")
    kw = {
        "cache_strategy": [strategy],
        "max_cache_length": [budget],
        "prompt_compression_strategy": [compressor],
        "global_tokens": global_tokens,
        "recent_window": 10,
        "cache_bits": cache_bits,
    }
    if strategy == "hybrid":
        kw["hybrid_strategies"] = HYBRID_MENU
        kw["token_ids"] = HYBRID_TOKEN_IDS
    return kw


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="Meta-Llama-3-8B-Instruct")
    ap.add_argument("--smoke", action="store_true", help="TestTiny on the CPU.")
    ap.add_argument("--weight_bits", type=int, default=4, choices=[16, 8, 4])
    ap.add_argument("--head_bits", type=int, default=4, choices=[8, 4])
    ap.add_argument("--cache_bits", type=int, default=8, choices=[16, 8, 4, 2])
    ap.add_argument("--strategy", default="heavy_hitter")
    ap.add_argument("--context", type=int, default=8192)
    ap.add_argument("--budget_frac", type=float, default=0.25)
    ap.add_argument("--decode_tokens", type=int, default=256)
    ap.add_argument("--global_tokens", type=int, default=4)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prefill_w4a8", action="store_true",
                    help="Prefill the int4 layer projections with the W4A8 kernel (int8 "
                         "activations) instead of bf16 dequantization.")
    ap.add_argument("--attn_i8dot", default="auto", choices=list(ATTN_I8DOT),
                    help=ATTN_I8DOT_HELP)
    ap.add_argument("--verbose", action="store_true",
                    help="Log the build and warm-up seconds and the perf dict, as bench.py.")
    args = ap.parse_args(argv)
    if args.prefill_w4a8 and args.weight_bits != 4:
        raise ValueError("--prefill_w4a8 needs int4 layers (--weight_bits 4)")
    if args.batch < 1:
        raise ValueError(f"--batch {args.batch}: at least one lane")
    if args.smoke:
        args.model, args.context, args.decode_tokens = "TestTiny", 128, 16
    return args


def run(args: argparse.Namespace) -> dict:
    from .caches import cache_memory_gb
    from .models.config import ModelConfig
    from .models.transformer import init_caches, init_params
    from .quantization.weight_quant import random_quantized_params
    from .runtime.engine import (
        build_cache_specs, build_model, cache_compatibility, params_from_flat,
    )
    from .runtime.generate import bucket_length, generate, generate_batch, reset_caches

    device = "cpu" if args.smoke else "cuda"
    cfg = ModelConfig.from_name(args.model)
    if cfg.block_size < args.context:
        print(f"[bench] context {args.context} exceeds {args.model}'s block_size; clamped "
              f"to {cfg.block_size} (use Meta-Llama-3.1-8B-Instruct for long contexts)",
              file=sys.stderr)
        args.context = cfg.block_size
    cache_bits = None if args.cache_bits == 16 else args.cache_bits
    kw = cache_kwargs(args.strategy, args.budget_frac, args.global_tokens, cache_bits)
    cache_compatibility(kw)
    log = print if args.verbose else (lambda *a, **k: None)
    t0 = time.time()
    if args.weight_bits == 16:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                             torch.bfloat16, device)
    else:
        params = params_from_flat(random_quantized_params(
            cfg, seed=0, mode=f"int{args.weight_bits}", head_mode=f"int{args.head_bits}"), device)
    model = build_model(cfg, params, device, max_positions=args.context,
                        prefill_w4a8=args.prefill_w4a8, attn_i8dot=ATTN_I8DOT[args.attn_i8dot])
    del params
    log(f"params built in {time.time() - t0:.1f}s")
    specs = build_cache_specs(cfg, kw, args.context)
    caches = init_caches(cfg, specs, args.batch, torch.bfloat16, device=device)

    prompt_len = args.context - args.decode_tokens - 8
    prompt = np.random.RandomState(0).randint(5, cfg.vocab_size - 5, size=prompt_len).tolist()
    bucket = bucket_length(prompt_len)
    if args.batch > 1:
        # Lanes of different lengths in one bucket: per-lane positions.
        prompts = [prompt[: prompt_len - 8 * b] for b in range(args.batch)]

        def run_once(caches):
            return generate_batch(model, caches, prompts, args.decode_tokens,
                                  prefill_bucket=bucket)
    else:

        def run_once(caches):
            return generate(model, caches, prompt, args.decode_tokens, prefill_bucket=bucket)

    # The warm-up run builds the kernels and, on the card, captures the decode graph.
    t0 = time.time()
    run_once(caches)
    log(f"compile+warmup in {time.time() - t0:.1f}s")
    reset_caches(caches)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _, info, caches = run_once(caches)
    perf = info["perf_stats"]
    log(json.dumps(perf, indent=2))
    model_bytes = sum(t.numel() * t.element_size() for t in model.buffers())
    value = perf["decode_toks_per_sec"]
    return {
        "metric": "decode_toks_per_sec",
        "value": round(value, 2),
        "unit": "tok/s",
        "config": {
            "model": args.model,
            "weight_bits": args.weight_bits,
            "head_bits": args.head_bits,
            "cache_bits": cache_bits,
            "strategy": args.strategy,
            "context": args.context,
            "budget_frac": args.budget_frac,
            "decode_tokens": args.decode_tokens,
            "batch": args.batch,
            "prefill_w4a8": args.prefill_w4a8,
            "attn_i8dot": args.attn_i8dot,
            "prefill_toks_per_sec": round(perf["prefill_toks_per_sec"], 1),
            "model_gb": round(model_bytes / 1e9, 2),
            "cache_memory_gb": round(sum(cache_memory_gb(c) for c in caches), 3),
            "memory_used_gb": round(perf["memory_used_gb"], 2),
            "weight_stream_gbps": round(model_bytes * value / 1e9, 1),
            "backend": device,
            "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            "card": card_line() if device == "cuda" else None,
        },
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if not args.smoke and not torch.cuda.is_available():
        print("bench: no CUDA device; pass --smoke to run TestTiny on the CPU",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    result = run(args)
    print(f"[bench] done in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
