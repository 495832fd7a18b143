"""The port's evaluation harness for KV-cache compression strategies.

Counterpart of the repository's ``eval.py`` (the JAX package's), with the
same flags, the same cache sizing and the same output files
(``args.json``, ``<task>_metrics.json``, ``<task>_args.json``,
``<task>_predictions.csv``, ``all_metrics.json``, under
``results/<model>/<strategies>/<cache options>`` or ``--out_dir``). Per
task: encode the prompts, size the cache (the longest sequence for
full/hybrid/debug strategies, the median estimate otherwise), pad every
prompt to one task-wide bucket (``--per_prompt_buckets``: each its own),
generate with cache resets between examples, aggregate the perf and cache
statistics and score the task's metrics. Generation tasks with
``--batch_size B`` run B lanes per ``generate_batch`` call (the last batch
padded with its last prompt); perplexity tasks and ``--feed_long_prompts``
/ ``--decode_first_token`` run one lane through ``generate()``,
teacher-forced for perplexity. It runs on the card unless ``--device cpu``
is given; decode replays a captured CUDA graph of one step there, and a
task's batches replay one graph. ``--profile DIR`` writes a
``torch.profiler`` trace per task. ``--tp N`` (with or without
``--tp_kernels``) and ``--dp M`` run N * M ranks (``parallel/``): each
holds its shard of the weights and KV heads, a dp replica runs
``--batch_size / M`` lanes of each batch (the batch size must divide), and
rank 0 writes the files. ``--sp/--pp`` above 1 raise.

    python -m cold_compress_tpu_torch.eval --tasks rulerniah --batch_size 4 \\
        --random_weights Meta-Llama-3-8B-Instruct --random_quantize int4 \\
        --cache_strategy heavy_hitter --prompt_compression_strategy heavy_hitter \\
        --max_cache_length 0.25 --cache_bits 8 --num_samples 8
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import re
import shutil
import sys
from collections import Counter, defaultdict
from contextlib import nullcontext
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from .caches import get_cache_strategy
from .device import resolve_device
from .evals.task import TASK_MAPPING, AutoTask
from .models.config import ModelConfig
from .models.transformer import init_caches, init_params
from .runtime.engine import (
    build_cache_specs,
    build_model,
    cache_compatibility,
    load_model,
    min_cache_length,
    params_from_flat,
)
from .runtime.generate import bucket_length, generate, generate_batch, reset_caches
from .runtime.stats import get_cache_stats
from .tokenizer import encode, get_tokenizer
from .utils.cli import (
    ATTN_I8DOT,
    add_cache_arguments,
    add_generation_arguments,
    merge_cache_config,
    validate_parallel,
)

RESULTS_DIR = Path(__file__).resolve().parents[1] / "results"
DP_LANES = ("--tp_kernels --dp shards batch lanes: needs --batch_size divisible by dp (and a "
            "batchable task config)")

_SIZE = ["max_cache_length", "max_seq_length", "cache_bits"]
#: The cache options that name a strategy's results directory (the JAX
#: package's ``relevant_kwargs`` of each strategy).
RELEVANT_KWARGS = {
    "full": _SIZE,
    "recent_global": _SIZE + ["global_tokens"],
    "random": _SIZE + ["global_tokens", "recent_window"],
    "l2": _SIZE + ["global_tokens", "recent_window"],
    "keep_it_odd": _SIZE + ["global_tokens", "recent_window"],
    "heavy_hitter": _SIZE + ["global_tokens", "history_window_size", "recent_window",
                             "attn_thresholding"],
    "hybrid": _SIZE + ["global_tokens", "min_recovery_frac", "hybrid_strategies"],
}


def flatten_dict(in_dict: dict) -> dict:
    out = {}
    for k, v in in_dict.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out[f"{k}_{kk}"] = vv
        else:
            out[k] = v
    return out


def compress_list(values):
    if len(values) < 3:
        return [str(x) for x in values]
    counter = Counter(values)
    return [f"{k}x{v}" for k, v in counter.items()]


def args_to_str(args) -> str:
    """Results-dir name from the cache options relevant to the chosen
    strategies."""
    if "debug" in args.cache_strategy[0]:
        debug_suffix = "__debug"
        cache_strategy = [re.sub(r"debug_+", "", cs).strip() for cs in args.cache_strategy]
    else:
        cache_strategy = args.cache_strategy
        debug_suffix = ""
    relevant = set()
    for cs in cache_strategy:
        relevant.update(RELEVANT_KWARGS[get_cache_strategy(cs).name])
    relevant.update({"cache_length_pattern", "cache_strategy_pattern"})
    if getattr(args, "attn_top_k", 1.0) != 1.0:
        relevant.add("attn_top_k")

    def process_num(n):
        if isinstance(n, float) and int(n) == n:
            return int(n)
        return n

    args_dict = vars(args).copy()
    if "hybrid_strategies" in args_dict and args_dict["hybrid_strategies"]:
        args_dict["hybrid_strategies"] = [x["strategy"] for x in args_dict["hybrid_strategies"]]
    parts = []
    for k, v in args_dict.items():
        if k not in relevant:
            continue
        if isinstance(v, list):
            parts.append(f"{k}=" + ",".join(compress_list([process_num(m) for m in v])))
        else:
            parts.append(f"{k}={process_num(v)}")
    return "__".join(sorted(parts)) + debug_suffix


def _short_token_probs(tokenizer, probs) -> dict:
    """The probability of every short vocabulary entry (answer letters): a
    logit task's prediction."""
    vocab = tokenizer.get_vocab()
    probs = np.asarray(probs)
    return {tok: float(probs[idx]) for idx, tok in enumerate(vocab[: len(probs)])
            if len(tok) <= 3}


def _strip_terminator(y: List[int], terminator_ids) -> List[int]:
    return y[:-1] if y and y[-1] in terminator_ids else y


def run_task(args, task, cfg: ModelConfig, model, tokenizer, is_chat: bool,
             terminator_ids: List[int], task_name: str = "task"):
    """One task: (metrics, prediction rows or None, the task's cache
    options), or (None, None, None) for a task with no test rows. On a rank
    of ``--tp/--dp`` the model is the rank's shard (``model.tp``) and its
    caches hold its KV heads and its replica's lanes."""
    device = model.device
    tp_ctx = model.tp
    aggregate = defaultdict(list)
    predictions, all_probs = [], []
    task_metrics = {}

    test = task.get_test()
    if len(test) == 0:
        print(f"No test data for {type(task).__name__}; skipping.")
        return None, None, None

    prompts = [r["prompt"] for r in test]
    inputs = [encode(tokenizer, p, is_chat=is_chat) for p in prompts]

    if task.requires_perplexity:
        label_ids = [encode(tokenizer, r["labels"][0], is_chat=False, bos=False) for r in test]
        max_seq_length = min(max(len(i) + len(lab) for i, lab in zip(inputs, label_ids)),
                             cfg.block_size)
    else:
        label_ids = None
        max_seq_length = min(max(len(i) for i in inputs) + task.max_tokens, cfg.block_size)

    # Cache sizing: full/hybrid/debug get the longest sequence, compressed
    # strategies the median estimate.
    median_seq_length = int(np.median([len(i) for i in inputs]) + task.max_tokens / 2)
    target_length = (
        max_seq_length
        if any(x in {"full", "hybrid"} or "debug" in x for x in args.cache_strategy)
        else min(median_seq_length, max_seq_length)
    )
    token_ids = None
    if "hybrid" in args.cache_strategy:
        token_ids = {"special": tokenizer.special_ids(),
                     "punctuation": tokenizer.punctuation_ids()}
    specs = build_cache_specs(cfg, vars(args), target_length, token_ids=token_ids)
    use_batch = batched(args, task)
    bs = args.batch_size if use_batch else 1
    dp = 1 if tp_ctx is None else tp_ctx.dp
    if dp > 1 and not (use_batch and bs % dp == 0):
        raise ValueError(DP_LANES)
    caches = init_caches(model.cfg, specs, bs // dp, torch.bfloat16, device=device)
    mcl = min_cache_length(specs)

    # One prefill bucket per task (the longest prompt's power of two), unless
    # --per_prompt_buckets pads each prompt to its own.
    task_bucket = None
    if inputs and not args.per_prompt_buckets:
        task_bucket = bucket_length(max(len(i) for i in inputs))

    profiler = nullcontext()
    trace_dir = args.profile if tp_ctx is None or tp_ctx.rank == 0 else None  # rank 0 writes
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)

    with profiler as prof:
        if use_batch:
            for start in range(0, len(inputs), bs):
                group = list(range(start, min(start + bs, len(inputs))))
                batch_prompts = [inputs[j] for j in group]
                # Pad the final partial batch by repeating the last prompt; the
                # surplus lanes are computed and discarded.
                batch_prompts += [batch_prompts[-1]] * (bs - len(group))
                max_new_tokens = min(task.max_tokens,
                                     max_seq_length - max(len(p) for p in batch_prompts))
                if max_new_tokens <= 0:
                    raise ValueError("Prompt too long for batch")
                seqs, info, caches = generate_batch(
                    model, caches, batch_prompts, max_new_tokens,
                    terminator_ids=terminator_ids, attn_top_k=args.attn_top_k,
                    prefill_bucket=task_bucket,
                )
                for k, v in info["perf_stats"].items():
                    aggregate[k].append(v)
                cache_stats = get_cache_stats(caches, int(np.mean(info["prompt_lengths"])),
                                              int(np.mean(info["num_generated"])))
                for k, v in cache_stats.items():
                    aggregate[k].append(v)
                for lane, j in enumerate(group):
                    y = _strip_terminator(seqs[lane][info["prompt_lengths"][lane]:],
                                          terminator_ids)
                    pred = tokenizer.decode(y)
                    if args.debug:
                        print(f"Prediction: {pred}")
                    predictions.append(pred)
                    if task.requires_logits:
                        all_probs.append(_short_token_probs(tokenizer, info["final_probs"][lane]))
                caches = reset_caches(caches)
                done = group[-1] + 1
                if done % 10 < bs:
                    print(f"  {done}/{len(inputs)} examples; agg decode tok/s="
                          f"{np.mean(aggregate['decode_toks_per_sec']):.1f}")
            inputs = []  # the per-example loop below is skipped

        for i, input_ids in enumerate(inputs):
            prompt_length = len(input_ids)
            max_new_tokens = min(task.max_tokens, max_seq_length - prompt_length)
            if max_new_tokens <= 0:
                raise ValueError(f"Prompt too long: {prompt_length}")
            # Teacher forcing follows the label length, clipped to the
            # generation budget (positions past the model's context are not
            # scored).
            next_tokens = None if label_ids is None else label_ids[i][:max_new_tokens]

            seq, info, caches = generate(
                model, caches, input_ids, max_new_tokens,
                next_tokens=next_tokens,
                terminator_ids=terminator_ids if next_tokens is None else None,
                attn_top_k=args.attn_top_k,
                feed_long_prompts=args.feed_long_prompts,
                decode_first_token=args.decode_first_token,
                min_cache_length=mcl,
                prefill_bucket=task_bucket,
            )
            for k, v in info["perf_stats"].items():
                aggregate[k].append(v)

            if next_tokens is not None:
                nll = -np.log(np.maximum(np.asarray(info["emitted_probs"]), 1e-20))
                # Slots past num_generated carry no probability.
                nll = nll[: int(info.get("num_generated", len(nll)))]
                # Non-finite teacher-forced steps are a numerics fault, counted
                # loudly rather than filtered silently.
                n_bad = int(np.sum(~np.isfinite(nll)))
                if n_bad:
                    print(f"WARNING: {n_bad}/{len(nll)} teacher-forced steps produced "
                          "non-finite NLL (dropped from ppl)", file=sys.stderr)
                    aggregate["ppl_nonfinite_steps"].append(n_bad)
                    nll = nll[np.isfinite(nll)]
                for k in range(500, len(nll), 500):
                    aggregate[f"ppl@{k}"].append(float(np.exp(np.mean(nll[:k]))))
                if len(nll):
                    aggregate["ppl"].append(float(np.exp(np.mean(nll))))

            cache_stats = get_cache_stats(caches, info["prompt_length"], info["num_generated"])
            for k, v in cache_stats.items():
                aggregate[k].append(v)

            if not task.requires_perplexity:
                y = _strip_terminator(seq[info["prompt_length"]:], terminator_ids)
                pred = tokenizer.decode(y)
                if args.debug:
                    print(f"Prediction: {pred}")
                predictions.append(pred)
                if task.requires_logits:
                    all_probs.append(_short_token_probs(tokenizer, info["final_probs"]))

            caches = reset_caches(caches)
            if (i + 1) % 10 == 0:
                print(f"  {i + 1}/{len(inputs)} examples; "
                      f"decode tok/s={np.mean(aggregate['decode_toks_per_sec']):.1f}")

    if trace_dir:
        trace = Path(trace_dir) / f"{task_name}.trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        print(f"Profile written to {trace}")

    print(f"Average tokens/sec: {np.mean(aggregate['total_toks_per_sec']):.2f}")
    task_metrics["max_memory_gb"] = float(np.max(aggregate["memory_used_gb"]))

    for k, v in aggregate.items():
        task_metrics[k] = sum(v) / len(v)
        if "toks_per_sec" in k:
            task_metrics[k] = list(v)
            sv = sorted(v)
            cutoff = math.ceil(len(sv) / 10)
            task_metrics[f"{k}_top_10p"] = sum(sv[-cutoff:]) / cutoff
        if k == "total_seconds":
            task_metrics[f"{k}_min"] = min(v)
            task_metrics[f"{k}_max"] = max(v)
            task_metrics[f"{k}_median"] = float(np.median(v))

    if task.requires_perplexity:
        pred_rows = None
    else:
        pred_units = all_probs if task.requires_logits else predictions
        task_metrics.update(flatten_dict(task.test_metrics(pred_units)))
        pred_rows = list(zip(prompts, predictions))

    task_args = {
        "max_cache_length": [s.max_cache_length for s in specs],
        "cache_strategy": [s.cache_strategy for s in specs],
        "target_length": target_length,
    }
    return task_metrics, pred_rows, task_args


def batched(args, task) -> bool:
    """Whether ``task`` (a task or its class) runs batched lanes: a
    generation task at ``--batch_size`` above 1; perplexity and
    prompt-feeding modes stay single-lane."""
    return (args.batch_size > 1 and not task.requires_perplexity
            and not args.feed_long_prompts and not args.decode_first_token)


def load(args, device: torch.device, tp_ctx=None):
    """(cfg, model, tokenizer, is_chat) for ``--random_weights`` (byte
    tokenizer; ``--random_quantize`` draws int8/int4 weights directly in
    quantized form, seed 0, else ``init_params`` bf16 weights, seed 0) or
    a checkpoint; with ``tp_ctx`` (a rank's context of any layout) the
    model is the rank's (``parallel/tp_decode.py::build_rank_model``)."""
    if args.random_weights:
        cfg = ModelConfig.from_name(args.random_weights)
        if args.random_quantize:
            from .quantization.weight_quant import random_quantized_params

            flat = random_quantized_params(
                cfg, seed=0, mode=args.random_quantize,
                head_mode="int4" if args.random_quantize == "int4" else "int8")
            params = params_from_flat(flat, device)
            del flat
        else:
            params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                 torch.bfloat16, device)
        tokenizer = get_tokenizer(None, "byte")
        is_chat = False
    else:
        checkpoint_path = Path(args.checkpoint_path)
        if not checkpoint_path.is_file():
            raise FileNotFoundError(checkpoint_path)
        cfg, params = load_model(checkpoint_path, model_name=args.model_name, device=device)
        tokenizer_path = checkpoint_path.parent / "tokenizer.model"
        if not tokenizer_path.is_file():
            tokenizer_path = checkpoint_path.parent
        is_chat = "chat" in str(checkpoint_path).lower() or "instruct" in str(
            checkpoint_path).lower()
        tokenizer = get_tokenizer(tokenizer_path, checkpoint_path, is_chat=is_chat)
    i8dot = ATTN_I8DOT[getattr(args, "attn_i8dot", "auto")]
    if tp_ctx is None:
        model = build_model(cfg, params, device, attn_i8dot=i8dot)
    else:
        from .parallel.tp_decode import build_rank_model

        model = build_rank_model(cfg, params, tp_ctx, attn_i8dot=i8dot)
    return cfg, model, tokenizer, is_chat


def _rank_main(tp_ctx, args, out_dir: Path) -> None:
    main(args, out_dir, tp_ctx)


def main(args, out_dir: Path, tp_ctx=None) -> None:
    """Run every task of ``args`` and write its files into ``out_dir``.
    With ``--tp/--dp/--sp/--pp`` above 1 this starts the ranks
    (``parallel/launch.py``), each of which runs ``main`` with its
    ``tp_ctx`` (its context of the layout); rank 0 writes. ``--sp`` and
    ``--pp`` run single-lane tasks only (the JAX package's refusals)."""
    validate_parallel(args)
    if args.sp * args.pp > 1 and any(batched(args, TASK_MAPPING[t]) for t in args.tasks):
        from .parallel.mesh import PP_ALONE, SP_LANES

        raise ValueError(SP_LANES if args.sp > 1 else PP_ALONE)
    if args.batch_size % args.dp:
        raise ValueError(DP_LANES)
    if tp_ctx is None and args.tp * args.dp * args.sp * args.pp > 1:
        from .parallel.launch import launch

        launch(_rank_main, args, out_dir, tp=args.tp, dp=args.dp, sp=args.sp, pp=args.pp,
               device=args.device)
        return
    device = tp_ctx.device if tp_ctx is not None else resolve_device(args.device)
    cfg, model, tokenizer, is_chat = load(args, device, tp_ctx)
    writes = tp_ctx is None or tp_ctx.rank == 0

    terminator_ids = tokenizer.get_terminator_ids()
    task_kwargs = {
        "model_max_length": cfg.max_length,
        "num_samples": args.num_samples,
        "tokenizer": tokenizer.encode_prompt if is_chat else tokenizer.encode,
    }
    if args.seq_length is not None:
        task_kwargs["seq_length"] = args.seq_length
    if args.ruler_context_sentences is not None:
        task_kwargs["context_sentences"] = args.ruler_context_sentences

    eval_tasks = {}
    for name in args.tasks:
        kw = dict(task_kwargs)
        if name not in ("pg19", "localtext"):
            kw.pop("seq_length", None)
        if not name.startswith("ruler"):
            kw.pop("context_sentences", None)
        try:
            eval_tasks[name] = AutoTask.from_name(name, **kw)
        except Exception as e:
            print(f"Task {name} unavailable: {e}")

    task_metrics = defaultdict(dict)
    args_fn = out_dir / "args.json"
    for task_name, task in eval_tasks.items():
        print(f"Running task {task_name} ...")
        task_out_fn = out_dir / f"{task_name}_metrics.json"
        if task_out_fn.exists() and not args.overwrite:
            print(f"Task {task_name} already evaluated. Skipping.")
            task_metrics[task_name] = json.loads(task_out_fn.read_text())
            continue
        metrics, pred_rows, task_args = run_task(args, task, cfg, model, tokenizer, is_chat,
                                                 terminator_ids, task_name)
        if metrics is None:
            continue
        task_metrics[task_name] = metrics
        if not writes:
            continue
        if pred_rows is not None:
            with open(out_dir / f"{task_name}_predictions.csv", "w") as fd:
                w = csv.writer(fd)
                w.writerow(["prompt", "prediction"])
                w.writerows(pred_rows)
        task_out_fn.write_text(json.dumps(metrics, indent=4, default=str))
        (out_dir / f"{task_name}_args.json").write_text(
            json.dumps(task_args, indent=4, default=str))
        if not args_fn.exists():
            args_fn.write_text(json.dumps({k: str(v) for k, v in vars(args).items()}, indent=4))
    if writes:
        (out_dir / "all_metrics.json").write_text(
            json.dumps(task_metrics, indent=4, default=str))
    print("ALL_TASKS_DONE")


def setup(args) -> Path:
    """The run's results directory (made, emptied first with
    ``--overwrite``), after the cache options' compatibility check."""
    sub_dir = args_to_str(args) if args.out_dir is None else args.out_dir
    model_dir = args.random_weights if args.random_weights else Path(
        args.checkpoint_path).parent.name
    out_dir = RESULTS_DIR / model_dir / "__".join(compress_list(args.cache_strategy)) / str(
        sub_dir)
    print(f"Saving to {out_dir}")
    if out_dir.exists() and args.overwrite:
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cache_compatibility(vars(args))
    return out_dir


def add_eval_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--tasks", type=str, nargs="+", default=["truthfulqa"],
                        choices=list(TASK_MAPPING.keys()) + ["all"])
    parser.add_argument("--out_dir", type=Path, default=None)
    parser.add_argument("--debug", default=False, action="store_true")
    parser.add_argument("--num_samples", type=int, default=-1,
                        help="Examples per task (-1 = all).")
    parser.add_argument("--overwrite", default=False, action="store_true")
    parser.add_argument("--seq_length", type=int, default=None, help="PG19 context length.")
    parser.add_argument("--ruler_context_sentences", type=int, default=None,
                        help="Synthetic RULER context size (filler sentences) when running "
                        "offline-synthesized RULER tasks.")
    parser.add_argument("--cache_config", type=str, default=None)
    parser.add_argument("--decode_first_token", default=False, action="store_true")
    parser.add_argument("--random_weights", type=str, default=None,
                        help="Run with a random-weight model (smoke testing).")
    parser.add_argument("--random_quantize", type=str, default=None, choices=["int8", "int4"],
                        help="Materialize --random_weights directly in quantized form "
                        "(throughput and harness behavior do not depend on weight values).")
    parser.add_argument("--per_prompt_buckets", default=False, action="store_true",
                        help="Pad each prompt to its own power-of-two bucket instead of one "
                        "task-wide bucket.")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="Lanes per generate_batch call for generation tasks.")


def build_parser(description: str = "Evaluation harness for KV-cache compression "
                 "strategies.") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    add_eval_args(parser)
    add_generation_arguments(parser)
    add_cache_arguments(parser)
    return parser


def parse_args(argv: Optional[Sequence[str]] = None,
               parser: Optional[argparse.ArgumentParser] = None) -> argparse.Namespace:
    """Parsed flags with the cache config overlaid and ``--tasks all``
    expanded."""
    args = merge_cache_config((parser or build_parser()).parse_args(argv))
    if args.tasks == ["all"]:
        args.tasks = list(TASK_MAPPING.keys())
    return args


def cli(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    validate_parallel(args)
    main(args, setup(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
