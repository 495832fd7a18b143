"""The port's tracer (``runtime/trace.py``): off it records nothing and
changes nothing; on, every span of a ``generate``/``generate_batch`` call
nests in its parent and shares the call's id, with one ``prefill.cache``
span per layer, four ``prefill.linear`` spans per layer and one for the
head, and one ``decode.step`` span per step run; the readings on
hand-built records; ``perf_stats`` against the formulas it had, and the
dp merge's rates from them; the ``--profile`` exporter's ranges. The ``cuda`` case (skipped without a card)
holds the captured decode graph to the same launches with the tracer on.
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch

from cold_compress_tpu_torch import generate as cli
from cold_compress_tpu_torch.caches import CacheSpec
from cold_compress_tpu_torch.caches import hybrid as TH
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.models.transformer import init_caches, init_params
from cold_compress_tpu_torch.runtime import trace
from cold_compress_tpu_torch.runtime.engine import build_model
from cold_compress_tpu_torch.runtime.generate import (_merge_perf, _perf_stats, generate,
                                                      generate_batch)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PROMPTS = [list(range(5, 45)), list(range(40, 73)), list(range(7, 27))]
MENU = [{"strategy": "special_punc"}, {"strategy": "full"}]
#: ``perf_stats`` keys, in order, as the parent built them.
KEYS = ["prefill_tokens", "decode_tokens", "decode_steps", "prefill_toks_per_sec",
        "decode_toks_per_sec", "total_toks_per_sec", "total_seconds", "prefill_seconds",
        "decode_seconds", "decode_seconds_frac_of_total", "memory_used_gb"]
BATCH_KEYS = ["batch_size"] + [k for k in KEYS if k != "decode_steps"]


@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig.from_name("TestTiny")
    return cfg, build_model(cfg, init_params(cfg, dtype=torch.float32, device="cpu"), "cpu",
                            max_positions=128)


def _specs(cfg, strategy):
    kw = dict(cache_strategy=strategy, max_seq_length=128, global_tokens=2, recent_window=4)
    if strategy == "hybrid":
        spec = CacheSpec(max_cache_length=64, prompt_compression_strategy="full",
                         hybrid_strategies=TH.normalize_hybrid_strategies(MENU),
                         token_ids_special=((5,),), token_ids_punc=(46,), **kw)
    else:
        spec = CacheSpec(max_cache_length=24, prompt_compression_strategy="heavy_hitter",
                         cache_bits=8, **kw)
    return [spec] * cfg.n_layer


def _call(cfg, model, strategy, batch, n_new=6, terminators=(3,)):
    """One call on fresh caches: ``(tokens, info)``."""
    prompts = PROMPTS if batch else PROMPTS[:1]
    caches = init_caches(cfg, _specs(cfg, strategy), len(prompts), torch.float32, device="cpu")
    if batch:
        seqs, info, _ = generate_batch(model, caches, prompts, n_new, terminator_ids=terminators)
        return seqs, info
    seq, info, _ = generate(model, caches, prompts[0], n_new, terminator_ids=terminators)
    return seq, info


def _traced(fn, *args, cuda=False, **kw):
    trace.start(cuda=cuda)
    try:
        out = fn(*args, **kw)
    finally:
        records = trace.stop()
    return out, records


def test_off_records_nothing_and_returns_the_shared_no_op(tiny):
    cfg, model = tiny
    assert trace.span("generate.call") is trace.span("decode.step", device=True)
    _, info = _call(cfg, model, "heavy_hitter", batch=False)
    assert list(info["perf_stats"]) == KEYS
    _, info = _call(cfg, model, "heavy_hitter", batch=True)
    assert list(info["perf_stats"]) == BATCH_KEYS
    assert trace.stop() == []
    trace.start(cuda=False)
    assert trace.stop() == []


@pytest.mark.parametrize("strategy", ["heavy_hitter", "hybrid"])
@pytest.mark.parametrize("batch", [False, True], ids=["generate", "generate_batch"])
def test_spans_nest_and_count_per_call(tiny, strategy, batch):
    """Two calls under one tracer: the same tokens and ``perf_stats`` keys
    as with the tracer off; each call's spans nest inside their parents'
    host intervals and carry its ``generate.call`` id; per call one
    ``prefill.cache`` and one ``prefill.attn`` span per layer, four
    ``prefill.linear`` per layer and one for the head, one ``decode.step``
    per step run and a stop read after each (terminators given)."""
    cfg, model = tiny
    off = [_call(cfg, model, strategy, batch, n_new=n) for n in (6, 1)]
    on, records = _traced(lambda: [_call(cfg, model, strategy, batch, n_new=n) for n in (6, 1)])
    for (t_off, i_off), (t_on, i_on) in zip(off, on):
        assert t_on == t_off
        assert list(i_on["perf_stats"]) == list(i_off["perf_stats"])
    assert [r["id"] for r in records] == list(range(len(records)))
    roots = [r for r in records if r["parent"] is None]
    assert [r["name"] for r in roots] == ["generate.call"] * 2
    for r in records:
        assert r["device"] is None  # no CUDA events for work on the CPU
        assert r["host"][0] <= r["host"][1]
        if r["parent"] is not None:
            parent = records[r["parent"]]
            assert r["call"] == parent["call"]
            assert parent["host"][0] <= r["host"][0] and r["host"][1] <= parent["host"][1]
        else:
            assert r["call"] == r["id"]
    for root, (_, info) in zip(roots, on):
        names = Counter(r["name"] for r in records if r["call"] == root["id"])
        steps = info["decode_steps"] if batch else info["perf_stats"]["decode_steps"]
        lanes = len(PROMPTS) if batch else 1
        assert root["attrs"] == {"lanes": lanes, "prompt_lengths": [len(p) for p in
                                                                    PROMPTS[:lanes]],
                                 "bucket": 64, "steps": steps}
        assert names["prefill.cache"] == names["prefill.attn"] == cfg.n_layer
        assert names["prefill.linear"] == 4 * cfg.n_layer + 1
        assert names["generate.prefill"] == 1
        assert names["decode.step"] == names["decode.stop_read"] == steps
        assert names["generate.decode"] == (steps > 0)


def test_perf_stats_keeps_its_formulas(tiny):
    """The one helper against a hand copy of the formulas ``generate`` and
    ``generate_batch`` each wrote out, for a call that decodes and one that
    does not (t2 = t1), given the seconds the call's clock readings span."""
    for t0, t1, t2 in ((1.0, 1.25, 2.0), (3.0, 3.5, 3.5)):
        for counts in ({"prefill_tokens": 40, "decode_tokens": 6, "decode_steps": 5},
                       {"batch_size": 3, "prefill_tokens": 93, "decode_tokens": 17}):
            n, d = counts["prefill_tokens"], counts["decode_tokens"]
            pre, dec, tot = t1 - t0, max(t2 - t1, 1e-9), t2 - t0
            want = {**counts, "prefill_toks_per_sec": n / max(pre, 1e-9),
                    "decode_toks_per_sec": d / dec, "total_toks_per_sec": d / max(tot, 1e-9),
                    "total_seconds": tot, "prefill_seconds": pre, "decode_seconds": dec,
                    "decode_seconds_frac_of_total": dec / max(tot, 1e-9), "memory_used_gb": 0.0}
            got = _perf_stats(counts, t1 - t0, t2 - t1, t2 - t0, 0.0)
            assert list(got) == list(want) and got == want


def test_dp_merge_rates_are_perf_stats_over_summed_tokens_and_longest_seconds():
    """Two dp replicas' ``perf_stats`` merge into one call's: tokens summed,
    each of the three seconds the longer replica's, the most memory, and
    every rate ``_perf_stats``'s over those (one replica decoded nothing)."""
    a = _perf_stats({"batch_size": 2, "prefill_tokens": 60, "decode_tokens": 14},
                    0.5, 1.5, 2.0, 3.25)
    b = _perf_stats({"batch_size": 2, "prefill_tokens": 33, "decode_tokens": 2},
                    0.75, 0.0, 0.75, 3.5)
    got = _merge_perf([a, b], 4)
    assert list(got) == BATCH_KEYS
    assert got == _perf_stats({"batch_size": 4, "prefill_tokens": 93, "decode_tokens": 16},
                              0.75, 1.5, 2.0, 3.5)
    assert got["prefill_toks_per_sec"] == 93 / 0.75 and got["decode_toks_per_sec"] == 16 / 1.5
    assert got["total_toks_per_sec"] == 16 / 2.0 and got["decode_seconds_frac_of_total"] == 0.75


def _rec(i, name, parent, call, host, device=None):
    ms = 1_000_000
    return {"name": name, "id": i, "parent": parent, "call": call, "attrs": {},
            "host": [host[0] * ms, host[1] * ms],
            "device": None if device is None else [device[0] * ms, device[1] * ms]}


#: Two calls, times in ms: the first prefills (linear 30 + 20, attention
#: 40, cache 50, of 280) and decodes three steps (100, 130 and 100 ms;
#: gaps 30 and 50 ms, of which the stop reads cover 20 and 20; launches 3,
#: 3 and 5 ms); the second only prefills (linear 70, cache 10, of 200).
RECORDS = [
    _rec(0, "generate.call", None, 0, (0, 1000)),
    _rec(1, "generate.prefill", 0, 0, (10, 400), (20, 300)),
    _rec(2, "prefill.linear", 1, 0, (11, 12), (30, 60)),
    _rec(3, "prefill.attn", 1, 0, (12, 13), (60, 100)),
    _rec(4, "prefill.cache", 1, 0, (13, 14), (100, 150)),
    _rec(5, "prefill.linear", 1, 0, (14, 15), (150, 170)),
    _rec(6, "generate.decode", 0, 0, (410, 990), (420, 980)),
    _rec(7, "decode.step", 6, 0, (430, 445), (440, 540)),
    _rec(8, "decode.launch", 7, 0, (441, 444)),
    _rec(9, "decode.stop_read", 6, 0, (446, 560)),
    _rec(10, "decode.step", 6, 0, (565, 580), (570, 700)),
    _rec(11, "decode.launch", 10, 0, (566, 569)),
    _rec(12, "decode.stop_read", 6, 0, (581, 720)),
    _rec(13, "decode.step", 6, 0, (730, 745), (750, 850)),
    _rec(14, "decode.launch", 13, 0, (731, 736)),
    _rec(15, "generate.call", None, 15, (2000, 3000)),
    _rec(16, "generate.prefill", 15, 15, (2001, 2300), (2010, 2210)),
    _rec(17, "prefill.linear", 16, 15, (2002, 2003), (2020, 2090)),
    _rec(18, "prefill.cache", 16, 15, (2003, 2004), (2100, 2110)),
]


def test_readings_on_hand_built_records():
    d = trace.decode_readings(RECORDS)
    want = {"decode_gap_pct": 100 * 80 / 560, "decode_graph_ms_per_step": 100.0,
            "decode_step_p99_ms": 150 + 0.99 * 10, "steps": 3, "gap_ms": 80 / 3,
            "stop_read_ms": 40 / 3, "loop_ms": 40 / 3, "launch_ms": 11 / 3}
    assert d.keys() == want.keys()
    for k, v in want.items():
        assert d[k] == pytest.approx(v, rel=1e-12), k
    p = trace.prefill_readings(RECORDS)
    want = {"prefill_linear_ms": 60.0, "prefill_cache_ms": 30.0, "calls": 2, "whole_ms": 240.0,
            "linear_ms": 60.0, "attn_ms": 20.0, "cache_ms": 30.0, "rest_ms": 130.0}
    assert p.keys() == want.keys()
    for k, v in want.items():
        assert p[k] == pytest.approx(v, rel=1e-12), k
    lines = trace.log_lines(RECORDS)
    assert len(lines) == 2 and "3 steps" in lines[0] and "2 calls" in lines[1]


def test_readings_are_none_without_device_times():
    records = [dict(r, device=None) for r in RECORDS]
    assert trace.decode_readings(records) is None
    assert trace.prefill_readings(records) is None
    assert trace.log_lines(records) == []
    assert trace.decode_readings([]) is None and trace.prefill_readings([]) is None


def test_profiled_opens_a_range_per_span(tiny):
    cfg, model = tiny
    with trace.profiled(False, cuda=False) as prof:
        assert prof is None
        assert trace.span("generate.call") is trace.span("decode.step")
    with trace.profiled(True, cuda=False) as prof:
        _call(cfg, model, "heavy_hitter", batch=False)
    assert trace.stop() == []  # the tracer is off again
    names = {e.key for e in prof.key_averages()}
    assert {"generate.call", "generate.prefill", "prefill.linear", "prefill.attn",
            "prefill.cache", "generate.decode", "decode.step", "decode.stop_read"} <= names


def test_cli_profile_writes_the_spans(tmp_path, capsys):
    out = tmp_path / "trace.json"
    assert cli.main(["--device", "cpu", "--random_weights", "TestTiny", "--prompt", "hello",
                     "--max_new_tokens", "4", "--profile", str(out)]) == 0
    names = {e.get("name") for e in json.loads(out.read_text())["traceEvents"]}
    assert {"generate.call", "generate.prefill", "prefill.linear", "generate.decode",
            "decode.step"} <= names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decode graph and CUDA events have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_and_tokens_are_the_same_with_the_tracer_on(card):
    """TestKernel, int4 weights, kv8 heavy hitter: a call that captures the
    decode graph with the tracer off and one that captures it anew (other
    caches) with the tracer on emit the same tokens and the same launches
    per replay; on, every step has device times and the readings add up."""
    from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params
    from cold_compress_tpu_torch.runtime.engine import build_cache_specs, params_from_flat

    cfg = ModelConfig.from_name("TestKernel")
    model = build_model(cfg, params_from_flat(random_quantized_params(cfg, seed=0), card), card,
                        max_positions=512)
    specs = build_cache_specs(cfg, {
        "cache_strategy": ["heavy_hitter"], "max_cache_length": [0.25],
        "prompt_compression_strategy": ["heavy_hitter"], "global_tokens": 4,
        "recent_window": 10, "cache_bits": 8}, 512)
    prompt = np.random.RandomState(0).randint(2, 500, size=300).tolist()
    kept, out = [], {}
    for on in (False, True):
        kept.append(init_caches(cfg, specs, 1, torch.bfloat16, device=card))  # a new capture
        if on:
            (seq, info, _), records = _traced(generate, model, kept[-1], prompt, 16, cuda=True,
                                              prefill_bucket=512, terminator_ids=[-5])
        else:
            seq, info, _ = generate(model, kept[-1], prompt, 16, prefill_bucket=512,
                                    terminator_ids=[-5])
        assert info["decode_graph"]["captured"]
        out[on] = (seq, info["decode_graph"]["launches_per_replay"], info["perf_stats"])
    assert out[True][0] == out[False][0]
    assert out[True][1] == out[False][1]
    names = Counter(r["name"] for r in records)
    assert names["decode.step"] == 15 and names["decode.launch"] == 14
    assert names["decode.capture"] == 1
    assert all(r["device"] for r in records if r["name"] == "decode.step")
    d, p = trace.decode_readings(records), trace.prefill_readings(records)
    perf = out[True][2]
    assert d["steps"] == 15 and 0 <= d["decode_gap_pct"] < 100
    assert p["whole_ms"] <= 1e3 * perf["prefill_seconds"]
    assert p["linear_ms"] > 0 and p["attn_ms"] > 0 and p["cache_ms"] > 0
    decode = next(r for r in records if r["name"] == "generate.decode")
    assert (decode["device"][1] - decode["device"][0]) * 1e-9 <= perf["decode_seconds"]
