"""The port's benchmark driver, ``python -m cold_compress_tpu_torch.bench``:
its CPU smoke configuration end to end, the configurations it serves (at
batch 1 and above) and the flags it refuses."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cold_compress_tpu_torch import bench
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]

#: ``bench.py``'s result keys, without ``vs_baseline`` (the reference's A100
#: figure), plus the card's name and power limit.
CONFIG_KEYS = {
    "model", "weight_bits", "head_bits", "cache_bits", "strategy", "context", "budget_frac",
    "decode_tokens", "batch", "prefill_w4a8", "attn_i8dot", "prefill_toks_per_sec", "model_gb",
    "cache_memory_gb",
    "memory_used_gb", "weight_stream_gbps", "backend", "device", "card",
}


def _check(result, **config):
    assert set(result) == {"metric", "value", "unit", "config"}
    assert result["metric"] == "decode_toks_per_sec" and result["unit"] == "tok/s"
    assert result["value"] > 0
    assert set(result["config"]) == CONFIG_KEYS
    for key, val in config.items():
        assert result["config"][key] == val, key
    assert result["config"]["backend"] == "cpu" and result["config"]["card"] is None


def test_smoke_command_prints_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "cold_compress_tpu_torch.bench", "--smoke"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    _check(json.loads(lines[0]), model="TestTiny", strategy="heavy_hitter", cache_bits=8,
           head_bits=4, context=128, decode_tokens=16, attn_i8dot="auto")


@pytest.mark.parametrize("argv,config", [
    (["--strategy", "l2", "--cache_bits", "4", "--head_bits", "8"],
     {"strategy": "l2", "cache_bits": 4, "head_bits": 8}),
    (["--strategy", "full", "--cache_bits", "16"], {"strategy": "full", "cache_bits": None}),
    (["--strategy", "random", "--cache_bits", "2", "--budget_frac", "0.5"],
     {"strategy": "random", "cache_bits": 2, "budget_frac": 0.5}),
    (["--strategy", "keep_it_odd", "--global_tokens", "8"], {"strategy": "keep_it_odd"}),
    (["--strategy", "recent_global", "--decode_tokens", "4"],
     {"strategy": "recent_global", "decode_tokens": 16}),
    (["--strategy", "hybrid"], {"strategy": "hybrid", "budget_frac": 0.25}),
    (["--strategy", "debug_heavy_hitter"], {"strategy": "debug_heavy_hitter"}),
    (["--prefill_w4a8"], {"strategy": "heavy_hitter", "prefill_w4a8": True}),
    (["--weight_bits", "8"], {"weight_bits": 8, "head_bits": 4}),
    (["--weight_bits", "8", "--head_bits", "8", "--strategy", "l2"], {"weight_bits": 8}),
    (["--weight_bits", "16", "--cache_bits", "16"], {"weight_bits": 16, "cache_bits": None}),
    (["--strategy", "debug_heavy_hitter", "--weight_bits", "8"],
     {"strategy": "debug_heavy_hitter", "weight_bits": 8}),
    (["--attn_i8dot", "off"], {"attn_i8dot": "off"}),
    (["--strategy", "l2", "--cache_bits", "4", "--attn_i8dot", "on"],
     {"attn_i8dot": "on", "cache_bits": 4}),
])
def test_smoke_serves_other_configurations(argv, config, capsys):
    """``--smoke`` fixes the model, context and token count; the cache and
    head options pass through."""
    assert bench.main(["--smoke", *argv]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    _check(json.loads(lines[0]), **config)


@pytest.mark.parametrize("argv", [
    ["--weight_bits", "8", "--batch", "2"], ["--weight_bits", "16", "--batch", "3"],
    ["--batch", "2"], ["--strategy", "hybrid", "--batch", "4"],
    ["--strategy", "debug_heavy_hitter", "--weight_bits", "8", "--batch", "2"],
])
def test_unported_flags_raise(argv, capsys):
    """``--batch`` above 1, which the port refused until ``generate_batch``
    was ported, now runs at every weight width and strategy: one JSON line
    with ``"batch": B``."""
    assert bench.main(["--smoke", *argv]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    _check(json.loads(lines[0]), batch=int(argv[argv.index("--batch") + 1]))


def test_verbose_logs_as_bench_py(capsys):
    """``--verbose`` logs what ``bench.py --verbose`` logs, on stdout before
    the JSON line: the build seconds, the warm-up seconds and the measured
    run's perf dict."""
    assert bench.main(["--smoke", "--verbose"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"params built in \d+\.\ds", lines[0])
    assert re.fullmatch(r"compile\+warmup in \d+\.\ds", lines[1])
    perf = json.loads("\n".join(lines[2:-1]))
    assert perf["decode_toks_per_sec"] > 0 and "prefill_toks_per_sec" in perf
    result = json.loads(lines[-1])
    _check(result, strategy="heavy_hitter")
    assert result["value"] == round(perf["decode_toks_per_sec"], 2)


@pytest.mark.parametrize("bits", ["8", "16"])
def test_prefill_w4a8_needs_int4_layers(bits):
    with pytest.raises(ValueError, match="int4 layers"):
        bench.parse_args(["--smoke", "--prefill_w4a8", "--weight_bits", bits])


def test_no_card_without_smoke(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--strategy", "l2"]) == 2
    assert "--smoke" in capsys.readouterr().err


def test_cache_options_follow_bench_py():
    """The prompt compressor ``bench.py`` pairs with each strategy, and a
    full cache at the whole context."""
    kw = bench.cache_kwargs("heavy_hitter", 0.25, 4, 8)
    assert kw["prompt_compression_strategy"] == ["heavy_hitter"]
    assert kw["max_cache_length"] == [0.25] and kw["cache_bits"] == 8
    full = bench.cache_kwargs("full", 0.25, 4, None)
    assert full["max_cache_length"] == [1.0] and full["prompt_compression_strategy"] == ["full"]
    for name in ("l2", "random", "recent_global", "keep_it_odd", "debug_heavy_hitter"):
        assert bench.cache_kwargs(name, 0.25, 4, 4)["prompt_compression_strategy"] == [
            "recent_global"]
    hybrid = bench.cache_kwargs("hybrid", 0.25, 4, 8)
    assert hybrid["max_cache_length"] == [1.0] and hybrid["prompt_compression_strategy"] == ["full"]
    assert [e["strategy"] for e in hybrid["hybrid_strategies"]] == [
        "special", "special_punc", "special_punc_heavy_hitter",
        "special_punc_heavy_hitter_window", "full"]
    assert hybrid["token_ids"] == {"special": [[1], [2]], "punctuation": list(range(16, 48))}
