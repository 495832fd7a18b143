#!/usr/bin/env python3
"""Where bf16 tensor parallelism parts from one card, on one card.

``chip_smoke.py``'s dense bf16 Llama-3-8B (``init_params`` seeded
``BF16_SEED``), the main path's heavy_hitter kv8 cache and 7928-token
prompt, ``--tokens`` greedy tokens and then the same tokens teacher-forced,
every run eager (no CUDA graph), in five forms:

* ``single``: one card, as ``generate`` runs it (the reference);
* ``single_f32_rows``: one card, ``wo`` and ``w2`` computed in f32 and
  rounded to bf16 once (what reassociating the f32 sums alone moves);
* ``split_bf16``: one card, ``wo`` and ``w2`` as tp = 2 computes them: each
  half of the input rows' product rounded to bf16, the halves summed in
  bf16 (plain PyTorch, one process);
* ``tp2``: two ranks of the port's tensor parallelism (gloo, sharing the
  card), as ``chip_smoke.py`` phase 6 runs it;
* ``tp2_f32_rows``: the same ranks with each rank's ``wo``/``w2`` partial
  sums kept in f32, all-reduced in f32 and rounded to bf16 once.

For each it prints how many greedy tokens equal ``single``'s (and
``split_bf16``'s) and the largest teacher-forced probability gap as a share
of the largest ``single`` probability. Run from the repository root in a
chip call:

    python3 scripts/torch_tp_reduce_ab.py --out chiprun_out/tp_reduce_ab.json
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch
from torch import nn

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402
from cold_compress_tpu_torch.bench import card_line  # noqa: E402


class RowSplit(nn.Module):
    """``x @ weight`` over ``parts`` blocks of the input rows: in ``bf16``
    each block's product rounded to bf16 and the blocks summed in bf16 in
    order (a row-parallel layer's partial sums and their all-reduce); in
    ``f32`` one f32 product returned in ``out_dtype`` (f32: partial sums
    left for an f32 all-reduce; bf16: rounded once)."""

    def __init__(self, weight: torch.Tensor, parts: int, mode: str, out_dtype):
        super().__init__()
        self.weight, self.parts, self.mode, self.out_dtype = weight, parts, mode, out_dtype

    def forward(self, x):
        if self.mode == "f32":
            return torch.matmul(x.float(), self.weight.float()).to(self.out_dtype)
        s = self.weight.shape[0] // self.parts
        out = None
        for i in range(self.parts):
            y = torch.matmul(x[..., i * s:(i + 1) * s], self.weight[i * s:(i + 1) * s])
            out = y if out is None else out + y
        return out


class F32Sum:
    """A ``TpContext`` whose all-reduce takes f32 partial sums and returns
    their sum rounded to bf16 (every other attribute the context's)."""

    def __init__(self, ctx):
        self._ctx = ctx

    def __getattr__(self, name):
        return getattr(self._ctx, name)

    def all_reduce(self, x):
        return self._ctx.all_reduce(x).to(torch.bfloat16)


def set_rows(model, make) -> None:
    """Replace each layer's ``wo`` and ``w2`` by ``make(weight)``."""
    for layer in model.layers:
        for owner, name in ((layer.attention, "wo"), (layer.feed_forward, "w2")):
            lin = getattr(owner, name)
            setattr(owner, name, make(getattr(lin, "orig", lin).weight))
            getattr(owner, name).orig = getattr(lin, "orig", lin)


def run(model, caches, prompt, n: int, teacher=None) -> dict:
    """``n`` greedy tokens, then ``teacher`` (default those) teacher-forced."""
    from cold_compress_tpu_torch.runtime.generate import generate, reset_caches

    reset_caches(caches)
    seq, _, caches = generate(model, caches, prompt, n, cuda_graph=False)
    reset_caches(caches)
    _, forced, _ = generate(model, caches, prompt, n, cuda_graph=False,
                            next_tokens=teacher or seq[len(prompt):])
    return {"tokens": seq[len(prompt):], "teacher_probs": forced["emitted_probs"]}


def single_runs(n: int) -> dict:
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import init_params
    from cold_compress_tpu_torch.runtime.engine import build_model

    dev = "cuda"
    cfg = ModelConfig.from_name(chip_smoke.MAIN_MODEL)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(chip_smoke.BF16_SEED),
                         torch.bfloat16, dev)
    model = build_model(cfg, params, dev, max_positions=chip_smoke.TP_CONTEXT)
    del params
    caches = chip_smoke.make_caches(cfg, chip_smoke.cache_kw("heavy_hitter", 8),
                                    chip_smoke.TP_CONTEXT, dev)
    prompt = chip_smoke.main_prompt(cfg)
    out = {"single": run(model, caches, prompt, n)}
    teacher = out["single"]["tokens"]
    set_rows(model, lambda w: RowSplit(w, 1, "f32", torch.bfloat16))
    out["single_f32_rows"] = run(model, caches, prompt, n, teacher)
    set_rows(model, lambda w: RowSplit(w, 2, "bf16", torch.bfloat16))
    out["split_bf16"] = run(model, caches, prompt, n, teacher)
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_job(ctx, n: int, teacher: list) -> dict:
    """One rank: the port's tp = 2 as is, then with f32 partial sums."""
    kw = chip_smoke.cache_kw("heavy_hitter", 8)
    cfg, model, caches, _ = chip_smoke.bf16_rank_model(ctx, kw)
    prompt = chip_smoke.main_prompt(cfg)
    out = {"tp2": run(model, caches, prompt, n, teacher)}
    set_rows(model, lambda w: RowSplit(w, 1, "f32", torch.float32))
    model.tp = F32Sum(ctx)
    out["tp2_f32_rows"] = run(model, caches, prompt, n, teacher)
    return out


def compare(got: dict, ref: dict) -> dict:
    g = np.asarray(got["teacher_probs"], np.float64)
    r = np.asarray(ref["teacher_probs"], np.float64)
    same = next((i for i, (a, b) in enumerate(zip(got["tokens"], ref["tokens"])) if a != b),
                len(ref["tokens"]))
    return {"tokens_equal": same, "of": len(ref["tokens"]),
            "gap": float(np.abs(g - r).max()), "gap_rel": float(np.abs(g - r).max() / r.max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tp_reduce_ab: no CUDA device", file=sys.stderr)
        return 2
    from cold_compress_tpu_torch.parallel.launch import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    runs = single_runs(args.tokens)
    ranks = launch(tp_job, args.tokens, runs["single"]["tokens"], tp=2, device="cuda",
                   backend="gloo")
    runs["tp2"], runs["tp2_f32_rows"] = ranks[0]["tp2"], ranks[0]["tp2_f32_rows"]
    result = {"card": card, "tokens": args.tokens, "seconds": time.perf_counter() - t0,
              "vs_single": {k: compare(v, runs["single"]) for k, v in runs.items()},
              "vs_split_bf16": {k: compare(runs[k], runs["split_bf16"])
                                for k in ("tp2", "tp2_f32_rows")},
              "ranks_agree": ranks[0] == ranks[1]}
    print(card)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**result, "runs": runs}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
