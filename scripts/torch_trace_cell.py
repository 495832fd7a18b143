#!/usr/bin/env python3
"""One benchmark cell with the program's tracer on over its window, beside
the same cell with the tracer off, on one card.

Each run is ``portbench.run.run_cell`` at ``--trace 0`` (set-up, the window,
the check). In a traced run ``runtime/trace.py``'s tracer starts at the
window's first call (``ranges=False``) and stops after the run; its records
give the five span readings (``trace.decode_readings``,
``trace.prefill_readings``) and the two log lines (``trace.log_lines``),
and are held against the calls' own ``perf_stats``:

* each call's ``generate.decode`` device length against its decode seconds;
* ``decode_graph_ms_per_step / (1 - decode_gap_pct / 100)`` against the
  window's median decode ms a step;
* each call's prefill device time (linear + attention + cache + rest)
  against its prefill seconds.

The tracer's cost is the traced runs' median decode ms a step and median
prefill seconds against the untraced runs' on the same seeds, the runs in
turns (off, on, on, off, ...). Run from the repository root on a machine
with a card:

    python3 scripts/torch_trace_cell.py --workload mistral_7b_v02.ruler_niah \\
        --seeds 2600000001 2600000002 --out trace_cell.json
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cold_compress_tpu_torch.runtime import generate as gen  # noqa: E402
from cold_compress_tpu_torch.runtime import trace  # noqa: E402
from portbench import spec  # noqa: E402
from portbench.run import card_line, run_cell  # noqa: E402
from portbench.traffic import Traffic  # noqa: E402


def log(msg: str) -> None:
    print(f"[trace_cell] {msg}", flush=True)


def one_run(cell, seed: int, seconds: float, on: bool, device: str = "cuda") -> dict:
    """``run_cell`` with each call's ``perf_stats`` kept; with ``on`` the
    tracer runs from the window's first call."""
    n_warm = len(Traffic(cell.traffic, cell.dims.vocab, seed).warm_prompts())
    calls = []
    originals = {name: getattr(gen, name) for name in ("generate", "generate_batch")}

    seen = [0]  # calls so far, of both entry points (a cell calls one of them)

    def wrap(fn):
        def call(*args, **kw):
            window = seen[0] >= n_warm
            if on and seen[0] == n_warm:
                trace.start()
            seen[0] += 1
            out = fn(*args, **kw)
            if window:
                info = out[1]
                steps = info.get("decode_steps", info["perf_stats"].get("decode_steps"))
                calls.append({**info["perf_stats"], "steps": int(steps)})
            return out
        return call

    for name, fn in originals.items():
        setattr(gen, name, wrap(fn))
    try:
        result = run_cell(cell, seed, seconds, False, device)
    finally:
        for name, fn in originals.items():
            setattr(gen, name, fn)
        records = trace.stop() if on else []
    run = {"seed": seed, "tracer": on, "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "calls": len(calls),
           "prefill_s_median": float(np.median([c["prefill_seconds"] for c in calls])),
           "decode_ms_per_step_median": float(np.median(
               [1e3 * c["decode_seconds"] / max(c["steps"], 1) for c in calls]))}
    if on:
        run.update(check_records(records, calls))
    return run


def check_records(records, calls) -> dict:
    """The five readings, the log lines and the consistency of the spans
    with the calls' ``perf_stats`` (calls and ``generate.call`` spans in
    the same order)."""
    d = trace.decode_readings(records) or {}
    p = trace.prefill_readings(records) or {}
    roots = [r for r in records if r["name"] == "generate.call"]
    by_call = {}
    for r in records:
        if r["name"] in ("generate.prefill", "generate.decode") and r["device"]:
            length = 1e-9 * (r["device"][1] - r["device"][0])
            by_call.setdefault(r["call"], {})[r["name"]] = length
    decode_rel, prefill_share = [], []
    for root, c in zip(roots, calls):
        spans = by_call.get(root["id"], {})
        if "generate.decode" in spans:
            decode_rel.append(spans["generate.decode"] / c["decode_seconds"] - 1)
        if "generate.prefill" in spans:
            prefill_share.append(spans["generate.prefill"] / c["prefill_seconds"])
    med_step = float(np.median([1e3 * c["decode_seconds"] / max(c["steps"], 1) for c in calls]))
    out = {"readings": {k: d.get(k) for k in ("decode_gap_pct", "decode_graph_ms_per_step",
                                             "decode_step_p99_ms")}
           | {k: p.get(k) for k in ("prefill_linear_ms", "prefill_cache_ms")},
           "decode": d, "prefill": p, "log_lines": trace.log_lines(records),
           "spans": len(records), "roots": len(roots),
           "decode_span_vs_seconds": [min(decode_rel, default=None),
                                      max(decode_rel, default=None)],
           "prefill_span_over_seconds": [min(prefill_share, default=None),
                                         max(prefill_share, default=None)],
           "captures": sum(r["name"] == "decode.capture" for r in records)}
    if d:
        implied = d["decode_graph_ms_per_step"] / (1 - d["decode_gap_pct"] / 100)
        out["step_implied_ms"] = implied
        out["step_implied_vs_median"] = implied / med_step - 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 3
    cell = spec.load_cell(args.workload)
    log(f"{cell.name}: {torch.cuda.get_device_name(0)} ({card_line()})")
    runs = []
    for i, seed in enumerate(args.seeds):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            t0 = time.perf_counter()
            run = one_run(cell, seed, args.seconds, on)
            run["run_s"] = time.perf_counter() - t0
            runs.append(run)
            log(json.dumps({k: v for k, v in run.items() if k not in ("decode", "prefill")}))
            for line in run.get("log_lines", []):
                log(line)
    summary = {}
    for on in (False, True):
        rs = [r for r in runs if r["tracer"] is on]
        summary["on" if on else "off"] = {
            k: statistics.median(r[k] for r in rs)
            for k in ("decode_ms_per_step_median", "prefill_s_median")}
    summary["cost"] = {k: summary["on"][k] / summary["off"][k] - 1 for k in summary["on"]}
    summary["cost_per_seed"] = [
        {k: on[k] / off[k] - 1 for k in summary["on"]}
        for off, on in zip(*[[r for r in runs if r["tracer"] is t] for t in (False, True)])]
    log(f"summary: {json.dumps(summary)}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps({"workload": cell.name, "card": card_line(), "runs": runs,
                                "summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
