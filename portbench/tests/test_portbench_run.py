"""A run of a tiny cell on the CPU, start to end, with the contract's last
line; the refusals without a card and outside a checkout."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run, spec
from portbench.tests import tiny

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("batch,bias", [(1, False), (4, True)])
def test_tiny_cell_prints_the_result_line(batch, bias, capsys):
    result = run.run_cell(tiny.cell(batch=batch, bias=bias), 2**31 + 17, 0.5, False, device="cpu")
    run.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= batch and line["attempted"] % batch == 0
    assert {"tok_s", "ttft_p95_s", "tpot_p95_ms", "setup_s"} <= set(line["metrics"])
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert "peak_gb" not in line["metrics"]  # no card: no device memory
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for name, c in line["checks"].items():
        assert f"[portbench] {name} {c['value']!r} limit {c['limit']!r}" in tail


def test_tiny_traced_run_reads_per_layer_metrics():
    result = run.run_cell(tiny.cell(batch=4, bias=True), 5, 0.5, True, device="cpu")
    # On the CPU no device operation is traced: the device metrics are left
    # out, the program's lane counts and prefill times are read.
    assert set(result["metrics"]) == {"lane_util_pct", "prefill_median_s"}
    assert result["device"]["window_s"] > 0 and result["device"]["busy_s"] == 0
    assert len(result["breakdown"]["idle_gaps"]) <= 10


def test_same_seed_same_served_tokens():
    """A window of no length serves one round, every call of the mix once:
    the same for the same seed."""
    cell = tiny.cell()
    a = run.run_cell(cell, 11, 0.0, False, device="cpu", control=True)
    b = run.run_cell(cell, 11, 0.0, False, device="cpu", control=True)
    assert a["attempted"] == b["attempted"] == len(tiny.LENGTHS)
    assert a["checks"] == b["checks"] and a["readings"] == b["readings"]
    assert a["control_mean_logp_err"] == b["control_mean_logp_err"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    assert run.main(["--workload", "mistral_7b_v02.ruler_niah", "--seed", "1",
                     "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


def test_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    prints no result and exits with another code than 0."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "mistral_7b_v02.ruler_niah", "--seed", "3", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_the_programs_tracer_runs_in_the_traced_round_alone(monkeypatch):
    """``--trace 1``: the program's tracer runs around the profiler's round
    and its launch counters are read around it, into ``Context.spans`` and
    ``Context.launches``, which a reader added as a file can read (here a
    probe that counts the ``generate.call`` spans). ``--trace 0`` never
    starts the tracer."""
    from cold_compress_tpu_torch.runtime import trace as program_trace

    starts = []
    real_start = program_trace.start

    def start(*args, **kw):
        starts.append(kw)
        return real_start(*args, **kw)

    monkeypatch.setattr(program_trace, "start", start)
    seen = []

    def probe(ctx):
        seen.append(ctx)
        return None if ctx.spans is None else sum(s["name"] == "generate.call" for s in ctx.spans)

    real_reader = run.metrics.reader
    monkeypatch.setattr(run.metrics, "reader",
                        lambda name: probe if name == "probe_calls" else real_reader(name))
    cell = tiny.cell()
    entry = {"name": "probe_calls", "unit": "calls"}
    cell.end_to_end, cell.per_layer = cell.end_to_end + [entry], cell.per_layer + [entry]

    untraced = run.run_cell(cell, 31, 0.0, False, device="cpu")
    assert not starts and seen[-1].spans is None and seen[-1].launches is None
    assert "probe_calls" not in untraced["metrics"]

    traced = run.run_cell(cell, 32, 0.0, True, device="cpu")
    ctx = seen[-1]
    assert starts == [{}]
    assert program_trace.stop() == []  # stopped after the round
    assert len(ctx.traced) == len(tiny.LENGTHS)  # one round: each call once
    assert traced["metrics"]["probe_calls"]["value"] == len(ctx.traced)
    assert {s["call"] for s in ctx.spans} == {s["id"] for s in ctx.spans
                                              if s["name"] == "generate.call"}
    assert isinstance(ctx.launches, dict)  # the CPU's plain versions count no launch
