"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the configuration's int4 weights on the card from the seed
(through the architecture module the configuration names, ``arch/``),
builds the model with ``runtime.engine.build_model``, the caches with
``runtime.engine.build_cache_specs`` and ``models.transformer.init_caches``,
and serves one warm call per prefill bucket the mix uses (which builds or
loads the kernels and captures the decode graph). The window then serves
whole rounds of the mix's calls (``portbench/traffic.py``), closed loop,
through ``runtime.generate.generate`` (one lane) or ``generate_batch``
(several), with ``reset_caches`` before each, and closes at the first end
of a round after ``--seconds``. With ``--trace 1`` the profiler then
records one more round (after the window: it slows each replayed decode
step about twofold), with the program's own tracer (``runtime/trace.py``)
on and its launch counters (``ops.kernel_launches``) read around it, and
the per-layer metrics are read from that round and from the window's
calls. Then the served tokens are checked against the
plain reference (``portbench/check.py``).

The last line of standard output is the JSON result; the numbers compared
are the last lines of standard error. Without a CUDA card, or with fewer
cards than the cell asks for, the run prints no result and exits with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import metrics, spec  # noqa: E402
from .check import READINGS, judge  # noqa: E402
from .trace import CALL, Profile, summarize  # noqa: E402
from .traffic import Traffic  # noqa: E402

#: Top-level module names that must not be loaded in the process that
#: prints the result: the JAX package and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "cold_compress_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _smi(fields: str) -> Optional[str]:
    """The first card's ``fields``, as ``nvidia-smi --query-gpu`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def card_line() -> Optional[str]:
    """The card's name and power limit."""
    return _smi("name,power.limit")


def card_state() -> Optional[str]:
    """The card's SM clock and its maximum, power draw, temperature and the
    active reasons for a slower clock (a bit mask)."""
    return _smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu,"
                "clocks_throttle_reasons.active")


@dataclass
class Context:
    """What the metric readers read (``portbench/metrics``): the
    architecture module (``arch``) and its sizes (``d``), the window's calls,
    and with ``--trace 1`` the traced round: the profiler's summary
    (``trace``), its calls (``traced``), the program's span records
    (``spans``, ``runtime/trace.py``) and its kernel launches by name
    (``launches``, ``ops.kernel_launches``); the last two None with
    ``--trace 0``."""

    arch: Any
    d: Any
    B: int
    C: int
    cache_bits: int
    records: List[dict]
    window_s: float
    setup_s: float
    peak_bytes: int
    on_card: bool = True
    trace: Optional[dict] = None
    traced: List[dict] = field(default_factory=list)
    spans: Optional[List[dict]] = None
    launches: Optional[Dict[str, int]] = None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, control: bool = False,
             program_control: bool = False) -> dict:
    """One run of ``cell``: set-up, the window, the metrics and the check.
    Returns the result line's fields, with ``log_lines`` for standard
    error (the numbers compared last). ``control`` adds the control's
    readings and the check's diagnosis (``check.judge``).
    ``program_control`` runs the program one step below each precision the
    configuration states where it has a path of its own for it (a 4-bit
    cache for the 8-bit one, int8 prefill activations for bf16:
    ``prefill_w4a8``), while the check still holds it to the stated ones
    (``calibrate.py --program_control_seeds``)."""
    from cold_compress_tpu_torch.models.transformer import init_caches
    from cold_compress_tpu_torch.runtime import engine
    from cold_compress_tpu_torch.runtime import generate as gen

    t_start = time.perf_counter() if t_start is None else t_start
    arch, d = cell.arch, cell.dims
    cfg = arch.port_config(cell)
    traffic = Traffic(cell.traffic, d.vocab, seed)
    cdoc = dict(cell.traffic["cache"])
    if program_control:
        cdoc["bits"] = 4
    kw = arch.cache_kwargs(cdoc, cfg)
    engine.cache_compatibility(kw)
    max_positions = max(max(traffic.buckets()), max(traffic.lengths) + traffic.max_new_tokens)
    params = arch.make_weights(d, seed, device)
    model = engine.build_model(cfg, params, device, max_positions=max_positions,
                               prefill_w4a8=program_control)
    del params
    specs = engine.build_cache_specs(cfg, kw, max_positions)
    C = engine.min_cache_length(specs)
    if C in traffic.lengths:
        raise ValueError(f"a prompt of {C} tokens would feed its last token through decode")
    caches = init_caches(cfg, specs, traffic.batch, torch.bfloat16, device=device)
    terminators = [int(t) for t in cell.config["port"]["terminators"]]

    def serve(prompts, new_tokens: int) -> dict:
        gen.reset_caches(caches)
        t0 = time.perf_counter()
        if len(prompts) == 1:
            seq, info, _ = gen.generate(model, caches, prompts[0], new_tokens,
                                        terminator_ids=terminators)
            lens = [info["prompt_length"]]
            served = [seq[lens[0]:]]
            probs = [info["emitted_probs"]]
            steps = info["perf_stats"]["decode_steps"]
        else:
            seqs, info, _ = gen.generate_batch(model, caches, prompts, new_tokens,
                                               terminator_ids=terminators)
            lens = list(info["prompt_lengths"])
            served = [s[n:] for s, n in zip(seqs, lens)]
            probs = info["emitted_probs"]
            steps = info["decode_steps"]
        wall = time.perf_counter() - t0
        perf = info["perf_stats"]
        return {"prompts": prompts, "lens": lens, "served": served, "probs": probs,
                "emitted": [len(s) for s in served], "steps": int(steps),
                "prefill_s": perf["prefill_seconds"], "decode_s": perf["decode_seconds"],
                "wall_s": wall,
                "stopped": sum(bool(s) and s[-1] in terminators for s in served)}

    for prompts in traffic.warm_prompts():
        serve(prompts, min(8, traffic.max_new_tokens))
    _sync(device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    states = [card_state()] if on_card else []

    records: List[dict] = []
    rounds = traffic.rounds()
    w0 = time.perf_counter()
    deadline = w0 + seconds
    while True:
        records += [serve(prompts, traffic.max_new_tokens) for prompts in next(rounds)]
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        states.append(card_state())

    summary, traced, spans, launches = None, [], None, None
    if trace:  # after the window, one round: the profiler slows the replayed steps
        from cold_compress_tpu_torch import ops
        from cold_compress_tpu_torch.runtime import trace as program_trace

        before = ops.kernel_launches()
        program_trace.start()  # outside the profile: start() and stop() synchronise
        try:
            with Profile() as prof:
                for prompts in next(rounds):
                    with torch.autograd.profiler.record_function(CALL):
                        traced.append(serve(prompts, traffic.max_new_tokens))
        finally:
            spans = program_trace.stop()
        launches = {k: n - before.get(k, 0) for k, n in ops.kernel_launches().items()
                    if n != before.get(k, 0)}
        summary = summarize(prof.events)
        del prof

    ctx = Context(arch=arch, d=d, B=traffic.batch, C=C, cache_bits=int(cdoc["bits"]),
                  records=records, window_s=window_s, setup_s=setup_s, peak_bytes=peak,
                  on_card=on_card, trace=summary, traced=traced, spans=spans, launches=launches)
    wanted = cell.per_layer if trace else cell.end_to_end
    values = {}
    for m in wanted:
        v = metrics.reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    lines = _run_lines(records, window_s, setup_s, terminators)
    if states:
        lines.append(f"card (SM MHz, max, W, C, slowdown reasons) before the window: "
                     f"{states[0]}; after: {states[1]}")
    if summary and summary.get("calls"):
        lines.append(_slowdown_line(records, summary["calls"]))
    if spans:
        lines += program_trace.log_lines(spans)
    if launches is not None:
        lines.append(_launch_line(launches, traced))
    served = records + traced
    keep_checked_layer(served[-1], caches[arch.checked_layer(d)])
    if control:  # the last call's cached positions, for the check's diagnosis
        served[-1]["cache_pos"] = [c.pos.cpu() for c in caches]
    del model, caches
    free_program_memory()
    t_check = time.perf_counter()
    verdict = judge(cell, served, seed, device, control=control)
    t_check = time.perf_counter() - t_check
    result = {
        "correct": bool(verdict["correct"]),
        "attempted": sum(len(r["lens"]) for r in served),
        "failed": 0,
        "metrics": values,
        "device": _device(device, peak, summary, cell.chips),
    }
    if summary and "breakdown" in summary:
        result["breakdown"] = summary["breakdown"]
    lines.append(f"checked {verdict['lanes']} requests, {verdict['tokens']} served tokens "
                 f"in {t_check!r} s")
    for k in READINGS:
        if k not in verdict["checks"]:
            lines.append(f"{k} {verdict[k]!r} (not compared)")
            result.setdefault("readings", {})[k] = verdict[k]
    if control:
        for k in sorted(k for k in verdict if k.startswith("control_")) + ["kept_overlap",
                                                                           "worst"]:
            result[k] = verdict[k]
            lines.append(f"{k} {verdict[k]!r}")

    result["checks"] = verdict["checks"]
    for name, c in verdict["checks"].items():
        lines.append(f"{name} {c['value']!r} limit {c['limit']!r}")
    result["log_lines"] = lines
    bad = forbidden_modules()  # after the readers, the check and the reference
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {bad}")
    return result


def keep_checked_layer(record: dict, cache) -> None:
    """The checked layer's cache after the call ``record`` (the last one
    served), per lane as the program reads it: positions, and K and V rows
    dequantized (``caches.materialize_kv``), on the host."""
    from cold_compress_tpu_torch.caches import materialize_kv

    k, v = materialize_kv(cache, torch.float32)
    record["checked_cache"] = [{"pos": cache.pos[b].cpu(), "k": k[b].cpu(), "v": v[b].cpu()}
                               for b in range(len(record["lens"]))]


def free_program_memory() -> None:
    """Return the program's memory (weights, caches, the decode graph's
    pool) before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _run_lines(records, window_s, setup_s, terminators) -> List[str]:
    lanes = sum(len(r["lens"]) for r in records)
    med = lambda xs: float(np.median(xs)) if xs else float("nan")  # noqa: E731
    drift = [r["wall_s"] - r["prefill_s"] - r["decode_s"] for r in records]
    return [
        f"window {window_s!r} s, set-up {setup_s!r} s: {len(records)} calls, {lanes} requests, "
        f"{sum(r['stopped'] for r in records)} stopped at a terminator {terminators}",
        f"medians: prefill {med([r['prefill_s'] for r in records])!r} s, decode "
        f"{med([r['decode_s'] for r in records])!r} s, steps "
        f"{med([r['steps'] for r in records])!r}, call {med([r['wall_s'] for r in records])!r} s",
        f"call clock minus prefill + decode seconds: median {med(drift)!r} s, "
        f"max {max(drift)!r} s",
        f"per call, in order: prefill s {[r['prefill_s'] for r in records]!r}; decode ms a "
        f"step {[1e3 * r['decode_s'] / max(r['steps'], 1) for r in records]!r}",
    ]


def _launch_line(launches: Dict[str, int], traced: List[dict]) -> str:
    """The program's kernel launches over the traced round, and each over
    the round's decode steps: a decode kernel's count per step; prefill's
    and the head's include the round's prefills."""
    steps = sum(r["steps"] for r in traced)
    per = {k: n / steps for k, n in sorted(launches.items())} if steps else {}
    return (f"program launches over the traced round ({steps} decode steps, "
            f"{len(traced)} calls): {dict(sorted(launches.items()))!r}; "
            f"launches over the round / decode steps {per!r}")


def _slowdown_line(records, calls) -> str:
    """How much the profiler slows a traced call: its decode and prefill
    seconds (the trace's clock) over the window's, per step and per call."""
    steps = sum(r["steps"] for r in records)
    t_steps = sum(c["steps"] for c in calls)
    untraced = sum(r["decode_s"] for r in records) / steps if steps else float("nan")
    traced = sum(c["decode_s"] for c in calls) / t_steps if t_steps else float("nan")
    pre = sum(r["prefill_s"] for r in records) / len(records)
    t_pre = sum(c["prefill_s"] for c in calls) / len(calls)
    return (f"profiler slowdown: decode step {traced!r} s traced against {untraced!r} s "
            f"untraced ({traced / untraced!r}x), prefill {t_pre!r} s against {pre!r} s "
            f"({t_pre / pre!r}x)")


def _device(device, peak: int, summary: Optional[dict], count: int) -> dict:
    on_card = torch.device(device).type == "cuda"
    out = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": count, "memory_peak_bytes": int(peak)}
    if on_card:
        out["card"] = card_line()
    if summary and "window_s" in summary:
        out["busy_s"] = summary["busy_s"]
        out["window_s"] = summary["window_s"]
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(result: dict) -> None:
    """The result's lines on standard error, then its JSON line last on
    standard output."""
    for line in result.pop("log_lines"):
        log(line)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    log(f"{cell.name}: {torch.cuda.get_device_name(0)} ({card_line()}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, seed {args.seed}")
    os.environ.setdefault("USE_FLAX", "0")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
