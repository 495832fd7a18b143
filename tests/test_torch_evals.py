"""The port's evaluation harness against the JAX package's: the metrics,
the offline task synthesis, the registry, and ``eval`` end to end on the
trained TinyByteLM128 fixture (the JAX ``eval.py`` runs in a subprocess on
the CPU); then the sweep and the job queue."""

import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cold_compress_tpu.evals import task as jax_task
from cold_compress_tpu.evals.metric import AutoMetric as JaxAutoMetric
from cold_compress_tpu.tokenizer import get_tokenizer as jax_get_tokenizer

from cold_compress_tpu_torch import eval as port_eval
from cold_compress_tpu_torch import eval_multi, parallelize_evals
from cold_compress_tpu_torch.evals import task as port_task
from cold_compress_tpu_torch.evals.metric import AutoMetric
from cold_compress_tpu_torch.ops import kernel_launches
from cold_compress_tpu_torch.tokenizer import get_tokenizer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "tests" / "fixtures" / "TinyByteLM128-hf" / "model.npz"


@pytest.fixture(autouse=True)
def offline_jax_tasks(monkeypatch):
    """The JAX tasks probe the hub before synthesizing; offline they
    synthesize, which is what they are compared on here."""
    monkeypatch.setattr(jax_task.EvaluationTask, "_hub_reachable", staticmethod(lambda: False))


# ---------------------------------------------------------------------------
# Metrics: tests/test_evals.py's cases on both packages
# ---------------------------------------------------------------------------

METRIC_CASES = [
    ("rouge", {}, ["the cat sat on the mat"], [["the cat sat on the mat"]]),
    ("rouge", {}, ["completely different words"], [["the cat sat"]]),
    ("rouge", {}, ["alpha beta"], [["unrelated text", "alpha beta"]]),
    ("accuracy", {}, ["A", "B", "C"], ["A", "B", "D"]),
    ("exact_match", {}, ["foo  bar"], ["foo bar"]),
    ("exact_match", {}, ["foo baz"], ["foo bar"]),
    ("levenshtein", {}, ["hello"], ["hello"]),
    ("levenshtein", {}, ["abc"], ["xyz"]),
    ("ruler-string-match", {"match_part": True}, ["the answers are X1 and X2"],
     [["x1", "x2", "x3"]]),
    ("ruler-string-match", {"match_part": False}, ["the answers are X1 and X2"],
     [["x1", "x2", "x3"]]),
]


@pytest.mark.parametrize("name,kw,preds,refs", METRIC_CASES)
def test_metrics_equal_jax(name, kw, preds, refs):
    got = AutoMetric.from_name(name, **kw).compute(None, preds, refs)
    assert got == JaxAutoMetric.from_name(name, **kw).compute(None, preds, refs)


def test_unknown_metric_raises():
    with pytest.raises(ValueError):
        AutoMetric.from_name("nope")


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------


def _task_kw(tokenizer, name):
    kw = dict(model_max_length=8192, tokenizer=tokenizer.encode, num_samples=4)
    if name.startswith("ruler"):
        kw["context_sentences"] = 20
    if name == "localtext":
        kw["seq_length"] = 64
    return kw


@pytest.mark.parametrize("name", ["rulerqa", "rulerniah", "rulervt", "rulercwe", "localtext",
                                  "localcode"])
def test_synthesized_rows_equal_jax(name):
    """Byte tokenizer, an 8192-token model: the same rows, subsampled the
    same way, with the same metrics."""
    task = port_task.AutoTask.from_name(name, **_task_kw(get_tokenizer(None, "byte"), name))
    ref = jax_task.AutoTask.from_name(name, **_task_kw(jax_get_tokenizer(None, "byte"), name))
    rows, ref_rows = task.get_test(), ref.get_test()
    assert rows == ref_rows and len(rows) > 0
    assert sorted(task.metrics) == sorted(ref.metrics)
    assert (task.max_tokens, task.requires_perplexity, task.requires_logits) == (
        ref.max_tokens, ref.requires_perplexity, ref.requires_logits)
    if not task.requires_perplexity:
        preds = [r["labels"][0] for r in rows]
        scores = task.test_metrics(preds)
        assert scores == ref.test_metrics(preds)
        if name.startswith("ruler"):  # the first answer alone scores
            assert scores["StringMatch"]["score"] > 0, scores


def test_registry_equals_jax():
    assert list(port_task.TASK_MAPPING) == list(jax_task.TASK_MAPPING)
    assert len(port_task.TASK_MAPPING) == 15
    with pytest.raises(ValueError):
        port_task.AutoTask.from_name("bogus")


def test_hub_tasks_download_lazily(monkeypatch):
    """A task without an offline synthesis imports ``datasets`` when it is
    built, and raises when the download fails; the synthesized tasks never
    import it."""
    monkeypatch.setitem(sys.modules, "datasets", None)  # import raises
    with pytest.raises(RuntimeError, match="no offline synthesis"):
        port_task.AutoTask.from_name("truthfulqa", model_max_length=2048,
                                     tokenizer=str.split, num_samples=2)
    port_task.AutoTask.from_name("rulerniah", model_max_length=2048, tokenizer=str.split,
                                 num_samples=2, context_sentences=10)


# ---------------------------------------------------------------------------
# eval end to end: the port in process, the JAX eval.py in a subprocess
# ---------------------------------------------------------------------------

#: Runs root ``eval.py`` with the arguments after the first, which names a
#: JSON file for each ``generate_batch`` call's lanes: sequences, prompt
#: lengths and emitted probabilities.
JAX_EVAL = """
import json, runpy, sys
import numpy as np
record, sys.argv = sys.argv[1], sys.argv[2:]
import cold_compress_tpu.evals.task as task
import cold_compress_tpu.runtime.generate as G
task.EvaluationTask._hub_reachable = staticmethod(lambda: False)
calls, batch = [], G.generate_batch
def recorded(*args, **kw):
    seqs, info, caches = batch(*args, **kw)
    calls.append({"seqs": [[int(t) for t in s] for s in seqs],
                  "prompt_lengths": [int(n) for n in info["prompt_lengths"]],
                  "emitted": [np.asarray(e, np.float64).tolist() for e in info["emitted_probs"]]})
    return seqs, info, caches
G.generate_batch = recorded
runpy.run_path("eval.py", run_name="__main__")
json.dump(calls, open(record, "w"))
"""
#: Keys of ``<task>_metrics.json`` that read clocks or the device's
#: memory, not the run's results.
TIMING_OR_MEMORY = ("toks_per_sec", "seconds", "memory_used_gb", "max_memory_gb")
#: |ln ppl (port) - ln ppl (JAX)|, nats per byte: tests/test_torch_trained.py's
#: bound for the trained weights over a compressed heavy-hitter cache.
PPL_NLL_TOL = 5e-3
#: Metrics computed in f32 on both sides (the compression ratios: a mean
#: over lanes and heads) differ by their summation order.
F32_RTOL = 1e-6
#: Greedy bytes each prediction shares with the JAX package's. The fixture
#: was trained on code and license text; on a RULER prompt its next-byte
#: distributions are flat, and a rounding difference flips a near-tie after
#: some tens of bytes: against the JAX XLA path the four predictions part
#: after 42, 126, 56 and 50 bytes (of 128), and the JAX package's own
#: batch-1 and batch-2 runs part after 116 and 67 bytes on two of them;
#: with a full cache the port and the JAX package part too, after 42, 26,
#: 128 and 35 bytes (ROADMAP section 3). The bytes themselves are held by
#: ``test_eval_batched_predictions_score_alike_under_the_port``.
PREFIX_BYTES = 32


def _eval_argv(tasks, out_dir, extra):
    return ["--device", "cpu", "--checkpoint_path", str(CKPT), "--tasks", *tasks,
            "--out_dir", str(out_dir), "--cache_strategy", "heavy_hitter",
            "--prompt_compression_strategy", "heavy_hitter", "--max_cache_length", "0.5",
            *extra]


@pytest.fixture(scope="module")
def both_evals(tmp_path_factory):
    """One run of each eval over rulerniah (4 samples, two lanes per
    ``generate_batch`` call, 20 filler sentences) and localtext (4
    samples, 64 bytes teacher-forced after a 512-byte prompt), a
    heavy-hitter cache at half the median sequence: (JAX results
    directory, port results directory, the JAX ``generate_batch`` calls'
    lanes, the port's calls as (model, cache specs, prefill bucket,
    sequences, emitted probabilities)).
    Both run one thread to a process (the port's through
    ``one_torch_thread``): the suite's workers share the cores."""
    import os

    tmp = tmp_path_factory.mktemp("evals")
    jax_dir, port_dir = tmp / "jax", tmp / "port"
    extra = ["--num_samples", "4", "--batch_size", "2", "--ruler_context_sentences", "20",
             "--seq_length", "64"]
    env = {**os.environ, "CCT_COMPILE_CACHE": str(tmp / "jax_cache"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"}
    out = subprocess.run([sys.executable, "-c", JAX_EVAL, str(tmp / "jax_calls.json"), "eval.py",
                          *_eval_argv(["rulerniah", "localtext"], jax_dir, extra)],
                         cwd=REPO, capture_output=True, text=True, timeout=900, env=env)
    assert out.returncode == 0 and "ALL_TASKS_DONE" in out.stdout, out.stderr[-3000:]
    calls, batch = [], port_eval.generate_batch

    def recorded(model, caches, prompts, max_new_tokens, **kw):
        out = batch(model, caches, prompts, max_new_tokens, **kw)
        calls.append((model, [c.spec for c in out[2]], kw["prefill_bucket"], out[0],
                      out[1]["emitted_probs"]))
        return out

    port_eval.generate_batch = recorded
    try:
        before = kernel_launches()
        assert port_eval.cli(_eval_argv(["rulerniah", "localtext"], port_dir, extra)) == 0
        assert kernel_launches() == before  # the CPU runs the plain versions
    finally:
        port_eval.generate_batch = batch
    return jax_dir, port_dir, json.loads((tmp / "jax_calls.json").read_text()), calls


def _metrics(out_dir, task):
    return json.loads((out_dir / f"{task}_metrics.json").read_text())


def _assert_results_equal(jax_dir, port_dir, task, skip=()):
    names = sorted(p.name for p in jax_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    want, got = _metrics(jax_dir, task), _metrics(port_dir, task)
    # The port's generate() also counts its decode steps.
    assert set(got) - set(want) <= {"decode_steps"} and set(want) <= set(got)
    for k, v in want.items():
        if any(t in k for t in TIMING_OR_MEMORY) or k in skip:
            continue
        rel = F32_RTOL if k.startswith("compression_ratio") else 1e-12
        assert got[k] == pytest.approx(v, rel=rel, abs=1e-12), k
    assert json.loads((port_dir / f"{task}_args.json").read_text()) == json.loads(
        (jax_dir / f"{task}_args.json").read_text())
    assert json.loads((port_dir / "args.json").read_text()).keys() >= json.loads(
        (jax_dir / "args.json").read_text()).keys() - {"compile"}
    return want, got


def test_eval_batched_rulerniah_equals_jax(both_evals):
    """rulerniah through ``generate_batch``: the same prompts and
    predictions that agree on their first ``PREFIX_BYTES`` greedy bytes,
    every metric that reads no clock or memory equal (the f32 ones to their
    rounding), and the same files."""
    jax_dir, port_dir, _, _ = both_evals
    rows = {}
    for side, d in (("jax", jax_dir), ("port", port_dir)):
        with open(d / "rulerniah_predictions.csv", newline="") as f:
            rows[side] = list(csv.reader(f))
    assert len(rows["port"]) == len(rows["jax"]) == 5 and rows["port"][0] == rows["jax"][0]
    for got, want in zip(rows["port"][1:], rows["jax"][1:]):
        assert got[0] == want[0]  # the prompt
        assert len(got[1]) >= PREFIX_BYTES and got[1][:PREFIX_BYTES] == want[1][:PREFIX_BYTES]
    want, got = _assert_results_equal(jax_dir, port_dir, "rulerniah")
    assert got["batch_size"] == 2 and "StringMatch_score" in got
    assert "compression_ratio_avg" in got and "cache_memory_gb" in got
    all_metrics = json.loads((port_dir / "all_metrics.json").read_text())
    assert set(all_metrics) == {"rulerniah", "localtext"}


def test_eval_batched_predictions_score_alike_under_the_port(both_evals):
    """The JAX eval's greedy bytes, each lane's teacher-forced through the
    port's ``generate()`` with the port's eval's cache specs and bucket:
    their perplexity under the port equals their perplexity under the JAX
    package (the probabilities it emitted) within the trained-weight NLL
    bound, over every generated byte of the task as its ``ppl`` is. Where
    the two predictions part, the port's probabilities of the two bytes
    are printed."""
    from cold_compress_tpu_torch.models.transformer import init_caches
    from cold_compress_tpu_torch.runtime.generate import generate

    _, _, jax_calls, port_calls = both_evals
    assert len(jax_calls) == len(port_calls) == 2
    gaps = []
    for jc, (model, specs, bucket, seqs, port_emitted) in zip(jax_calls, port_calls):
        for b, (seq, P, emitted) in enumerate(zip(jc["seqs"], jc["prompt_lengths"],
                                                 jc["emitted"])):
            gen, own = seq[P:], seqs[b][P:]
            assert seqs[b][:P] == seq[:P]
            caches = init_caches(model.cfg, specs, 1, torch.bfloat16, device="cpu")
            _, info, _ = generate(model, caches, seq[:P], len(gen), prefill_bucket=bucket,
                                  next_tokens=gen)
            p = np.asarray(info["emitted_probs"], np.float64)
            assert p.shape == (len(gen),) and np.all(p > 0)
            gaps.append(np.log(p) - np.log(np.asarray(emitted)))
            d = next((i for i, (x, y) in enumerate(zip(gen, own)) if x != y), None)
            if d is not None:
                print(f"prompt of {P} bytes: parts at byte {d}: the JAX byte {gen[d]} (its "
                      f"p {emitted[d]:.5f}, the port's {p[d]:.5f}), the port's byte {own[d]} "
                      f"(p {float(port_emitted[b][d]):.5f})")
    nll_gap = abs(float(np.concatenate(gaps).mean()))
    print(f"|ln ppl (port) - ln ppl (JAX)| over the JAX predictions: {nll_gap:.3e}")
    assert nll_gap <= PPL_NLL_TOL


def test_eval_teacher_forced_localtext_equals_jax(both_evals):
    """localtext's perplexity path (one lane, teacher-forced): the same
    cache statistics, and the perplexity within the trained-weight NLL
    bound."""
    jax_dir, port_dir, _, _ = both_evals
    want, got = _assert_results_equal(jax_dir, port_dir, "localtext", skip=("ppl",))
    assert 1.0 < got["ppl"] < 20.0
    assert abs(np.log(got["ppl"]) - np.log(want["ppl"])) <= PPL_NLL_TOL
    assert not (port_dir / "localtext_predictions.csv").exists()


def test_eval_refuses_parallelism_and_skips_finished_tasks(tmp_path, capsys):
    argv = _eval_argv(["rulervt"], tmp_path, ["--num_samples", "1",
                                              "--ruler_context_sentences", "4"])
    # The JAX package's refusals: --sp and --pp take single-lane runs only
    # (rulervt is a generation task, so --batch_size 2 batches it).
    for extra, match in ((["--sp", "2", "--dp", "2"], "single-lane runs"),
                         (["--sp", "2", "--batch_size", "2"], "single-lane runs"),
                         (["--pp", "2", "--batch_size", "2"], "--pp runs alone")):
        with pytest.raises(ValueError, match=match):
            port_eval.cli([*argv, *extra])
    # TinyByteLM128 has one KV head; dp shards the lanes of a batch.
    with pytest.raises(ValueError, match="must divide n_kv_head=1"):
        port_eval.cli([*argv, "--tp", "2"])
    with pytest.raises(ValueError, match="needs --batch_size divisible by dp"):
        port_eval.cli([*argv, "--dp", "2"])
    assert port_eval.cli(argv) == 0
    assert port_eval.cli(argv) == 0
    assert "already evaluated" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The sweep and the job queue
# ---------------------------------------------------------------------------


def test_eval_multi_runs_each_grid_value(tmp_path, monkeypatch):
    monkeypatch.setitem(eval_multi.HPARAMS, "max_cache_length", [[0.5], [0.25]])
    monkeypatch.setattr(port_eval, "RESULTS_DIR", tmp_path)
    seen = []
    monkeypatch.setattr(port_eval, "main",
                        lambda args, out_dir: seen.append((args.max_cache_length, out_dir)))
    assert eval_multi.main(["--device", "cpu", "--random_weights", "TestTiny", "--tasks",
                            "rulerniah", "--cache_strategy", "l2",
                            "--prompt_compression_strategy", "l2"]) == 0
    assert [v for v, _ in seen] == [[0.5], [0.25]]
    assert seen[0][1] != seen[1][1] and all(d.is_dir() and tmp_path in d.parents
                                            for _, d in seen)
    assert "max_cache_length=0.5" in str(seen[0][1])
    with pytest.raises(ValueError, match="HPARAMS"):
        eval_multi.main(["--hparam", "global_tokens"])


def test_parallelize_evals_journals_and_resumes(tmp_path):
    """Two slots run a queue of trivial commands, each pinned through
    CUDA_VISIBLE_DEVICES, and journal them; a queue stopped with jobs left
    (written as an interrupted run leaves it) resumes those, the running
    one first."""
    log_dir = tmp_path / "logs"
    cmds = [f"{sys.executable} -c \"import os; print('job{i}', os.environ['CUDA_VISIBLE_DEVICES'])\""
            for i in range(4)] + [f"{sys.executable} -c \"raise SystemExit(3)\""]
    (tmp_path / "cmds.txt").write_text("# a comment\n" + "\n".join(cmds) + "\n")
    assert parallelize_evals.main(["--command_file", str(tmp_path / "cmds.txt"), "--num_slots",
                                   "2", "--log_dir", str(log_dir)]) == 1
    journal = json.loads((log_dir / "completed.json").read_text())
    assert sorted(j["cmd"] for j in journal["completed"]) == sorted(cmds[:4])
    assert [j["exit_code"] for j in journal["failed"]] == [3] and journal["running"] == []
    assert json.loads((log_dir / "queue.json").read_text()) == []
    logs = "".join((log_dir / f"slot_{s}.log").read_text() for s in (0, 1)
                   if (log_dir / f"slot_{s}.log").exists())
    for i in range(4):
        assert f"job{i} " in logs
    assert set(line.split()[1] for line in logs.splitlines() if line.startswith("job")) <= {
        "0", "1"}

    (log_dir / "queue.json").write_text(json.dumps(cmds[2:4]))
    (log_dir / "completed.json").write_text(json.dumps(
        {"completed": [], "failed": [], "running": [cmds[1]]}))
    assert parallelize_evals.pending_commands(log_dir) == cmds[1:4]
    assert parallelize_evals.main(["--resume", "--log_dir", str(log_dir)]) == 0
    journal = json.loads((log_dir / "completed.json").read_text())
    assert sorted(j["cmd"] for j in journal["completed"]) == sorted(cmds[1:4])


def test_sweep_grid_commands_run_the_port():
    args = parallelize_evals.parse_args(["--cache_configs", "heavy_hitter", "l2", "--tasks",
                                         "rulerniah", "--cache_sizes", "0.25", "0.5"])
    cmds = parallelize_evals.build_commands(args)
    assert len(cmds) == 4 and all("-m cold_compress_tpu_torch.eval " in c for c in cmds)
    assert args.device_env == "CUDA_VISIBLE_DEVICES"
