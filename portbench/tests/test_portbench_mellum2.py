"""Mellum2 in the benchmark: its architecture module arrives as added files
(``arch/mellum2.py``, ``reference/mellum2.py``, the configuration, the mix,
the limits, two readers), the tiny Mellum2 cell runs through the harness
on the CPU and comes out correct, its controls and a routing fault do not,
and the work counts agree with numbers worked by hand."""

import pytest
import torch

from cold_compress_tpu_torch.models import transformer
from portbench import arch, metrics, run, spec
from portbench.arch import mellum2
from portbench.tests import tiny_mellum2

CELL = "mellum2_12b_a2p5b.repobench_8k_16k_b4"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_cell_names_the_mellum2_module_and_the_program_agrees():
    cell = spec.load_cell(CELL)
    assert cell.arch is arch.load("mellum2")
    d = cell.dims
    assert (d.n_layer, d.dim, d.n_head, d.n_kv_head, d.head_dim) == (28, 2304, 32, 4, 128)
    assert (d.n_experts, d.top_k, d.expert_width, d.vocab) == (64, 8, 896, 98304)
    assert (d.full_layers, d.sliding_layers, d.sliding_window) == (7, 21, 1024)
    assert mellum2.checked_layer(d) == 3
    cfg = cell.arch.port_config(cell)  # raises where the registry differs
    assert cfg.head_dim == 128 and cfg.rope_scaling.rope_type == "yarn"
    assert cell.config["port"]["architecture"] == "mellum2"
    assert cell.traffic["calls"] == [[8064] * 4, [16256] * 4]
    assert set(cell.limits) == {"kv_rel_err_l0", "pos_miss_l0"}
    names = {m["name"] for m in cell.per_layer}
    assert {"moe_gemv_roofline_pct", "prefill_moe_ms", "decode_mfu_pct", "prefill_mfu_pct",
            "lane_util_pct"} <= names


def test_a_registry_entry_that_differs_is_refused():
    cell = spec.load_cell(CELL)
    cell.config["port"]["set"] = {"n_experts_per_tok": 7}
    with pytest.raises(ValueError, match="n_experts_per_tok"):
        cell.arch.port_config(cell)


@pytest.mark.parametrize("batch", [1, 3])
def test_tiny_mellum2_is_correct_and_follows_the_reference_to_the_bit(batch):
    r = run.run_cell(tiny_mellum2.cell(batch=batch), 0, 0.3, False, device="cpu")
    assert r["correct"]
    assert {k: c["value"] for k, c in r["checks"].items()} == {"kv_rel_err_l0": 0.0,
                                                              "pos_miss_l0": 0.0}
    assert r["readings"]["max_logit_gap"] == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_the_control_fails_where_the_program_passes(seed):
    r = run.run_cell(tiny_mellum2.cell(batch=3), seed, 0.0, False, device="cpu",
                     control=True)
    assert r["correct"]
    assert any(r[f"control_{name}"] > c["limit"] for name, c in r["checks"].items())


def test_routing_without_renormalisation_is_not_correct(monkeypatch):
    real = transformer.route

    def unnormalised(moe, x):
        probs = torch.softmax(torch.matmul(x.float(), moe.router), dim=-1)
        wts, ids = torch.topk(probs, moe.top_k, dim=-1)
        return ids, wts

    monkeypatch.setattr(transformer, "route", unnormalised)
    assert not run.run_cell(tiny_mellum2.cell(batch=3), 0, 0.0, False, device="cpu")["correct"]
    monkeypatch.setattr(transformer, "route", real)


def dims():
    return mellum2.dims(spec.load_json(spec.HERE / "configs" / "mellum2_12b_a2p5b.json"))


def test_work_counts_by_hand():
    d = dims()
    assert mellum2.uniform_distinct(d, 1) == pytest.approx(8.0)
    assert mellum2.uniform_distinct(d, 4) == pytest.approx(64 * (1 - (56 / 64) ** 4))
    assert mellum2.uniform_distinct(d, 4) == pytest.approx(26.484375)
    # per layer: attention 2304x5120 + 4096x2304, 64 experts of 2304x1792 +
    # 896x2304; int4 values in/2*out bytes, bf16 scale and zero per 128 inputs.
    attn = (5_898_240 + 368_640) + (4_718_592 + 294_912)
    expert = (2_064_384 + 129_024) + (1_032_192 + 64_512)
    head = 113_246_208 + 7_077_888
    assert mellum2.weight_bytes(d) == 28 * (attn + 64 * expert) + head == 6_332_055_552
    # a step at B = 4: ~26.5 experts a layer (2.44 GB), the attention
    # projections (0.32 GB), the head (0.12 GB) and the caches (0.16 GB)
    step = mellum2.decode_step(d, 4, 2048, 8)
    assert 3.0e9 < step.nbytes < 3.1e9
    one = mellum2.expert_gemvs(d, 1, 8.0)
    assert one.nbytes == 8 * expert + 2 * 2 * 2304
    assert one.int8_ops == 2 * 8 * 3 * 2304 * 896
    # the sliding layers' prefill attention over four 16256-token prompts:
    # the true pairs of a 1024-key window, no summaries
    pairs = 16256 * 1024 - 1024 * 1023 // 2
    assert mellum2.window_pairs([16256], 1024) == pairs
    w = mellum2.prefill_attention(d, [16256] * 4, 1024)
    assert w.bf16_flops == 4 * 128 * 32 * 4 * pairs
    assert 21 * w.bf16_flops == pytest.approx(22.2e12, rel=0.01)
    assert mellum2.prefill(d, [16256] * 4).bf16_flops > 21 * w.bf16_flops
    assert mellum2.moe_gemv_seconds(d, 4, 26.5) == pytest.approx(
        28 * mellum2.expert_gemvs(d, 4, 26.5).seconds())


def ctx_for(cell, **kw):
    d = cell.dims
    base = dict(arch=cell.arch, d=d, B=4, C=2048, cache_bits=8, records=[], window_s=30.0,
                setup_s=10.0, peak_bytes=0)
    base.update(kw)
    return run.Context(**base)


def test_the_new_readers_read_the_program_and_return_none_without_it():
    cell = spec.load_cell(CELL)
    moe, pre = metrics.reader("moe_gemv_roofline_pct"), metrics.reader("prefill_moe_ms")
    assert moe(ctx_for(cell)) is None and pre(ctx_for(cell)) is None
    kernel = "void (anonymous namespace)::moe_w4a8_gemv_kernel<0>(__nv_bfloat16 const*)"
    trace = {"calls": [{"steps": 10}], "kernels": {"decode": {kernel: [20, 0.05]}}}
    launches = {f"moe_gemv.experts.{i}": 265 for i in range(28)}
    traced = [{"steps": 10, "lens": [8064] * 4}]
    # the parent's program: no counter in its launches, no span
    assert moe(ctx_for(cell, trace=trace, traced=traced, launches={})) is None
    got = moe(ctx_for(cell, trace=trace, traced=traced, launches=launches))
    least = mellum2.moe_gemv_seconds(cell.dims, 4, 26.5)
    assert got == pytest.approx(100 * 10 * least / 0.05)
    spans = [{"name": "generate.prefill", "call": 0, "device": [0, 5]},
             {"name": "prefill.moe", "call": 0, "device": [0, 3_000_000]},
             {"name": "prefill.moe", "call": 0, "device": [0, 1_000_000]},
             {"name": "generate.prefill", "call": 9, "device": [0, 5]}]
    assert pre(ctx_for(cell, spans=spans)) == pytest.approx(2.0)
    assert pre(ctx_for(cell, spans=spans[:1])) is None
