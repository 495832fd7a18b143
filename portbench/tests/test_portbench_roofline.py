"""The yardstick's counts (``roofline.py``, ``arch/dense.py``) at the two
configurations' shapes, against numbers worked by hand."""

import pytest

from portbench import roofline, spec
from portbench.arch import dense


def dims(name):
    return dense.dims(spec.load_json(spec.HERE / "configs" / f"{name}.json"))


def test_mistral_weight_bytes_by_hand():
    # per layer: qkv 4096x6144, o 4096x4096, w13 4096x28672, w2 14336x4096:
    # int4 values in/2*out bytes, bf16 scale and zero per 128 inputs.
    layer = (12_582_912 + 786_432) + (8_388_608 + 524_288) + (58_720_256 + 3_670_016) \
        + (29_360_128 + 1_835_008)
    head = 65_536_000 + 4_096_000
    assert dense.weight_bytes(dims("mistral_7b_v02")) == 32 * layer + head == 3_777_396_736


def test_qwen2_weight_bytes_by_hand():
    layer = (8_257_536 + 516_096) + (6_422_528 + 401_408) + (67_895_296 + 4_243_456) \
        + (33_947_648 + 2_121_728)
    head = 272_498_688 + 17_031_168
    assert dense.weight_bytes(dims("qwen2_7b")) == 28 * layer + head == 3_756_089_344


@pytest.mark.parametrize("name,act", [("mistral_7b_v02", 32 * 2 * 69_632 + 2 * 36_096),
                                      ("qwen2_7b", 28 * 2 * 79_360 + 2 * 155_648)])
def test_decode_gemvs_are_bytes_bound_at_one_lane(name, act):
    # act: bf16 x in and y out of each projection, (in + out) * 2 bytes.
    d = dims(name)
    w = dense.decode_gemvs(d, 1)
    assert w.nbytes == dense.weight_bytes(d) + act
    assert w.seconds() == pytest.approx(w.nbytes / 3.35e12)
    assert w.int8_ops / roofline.PEAK_INT8_OPS < w.nbytes / roofline.PEAK_BYTES


def test_mistral_decode_step_bound():
    # 3.78 GB of weights a step: 1.13 ms at 3.35 TB/s.
    assert dense.decode_gemvs(dims("mistral_7b_v02"), 1).seconds() == pytest.approx(
        1.1289e-3, rel=1e-3)


def test_decode_attention_by_hand():
    d = dims("mistral_7b_v02")
    w = dense.decode_attention(d, 1, 2048)
    # 8 KV heads x 2048 slots x (256 B of K and V, 4 f32 scales/zeros, a mask
    # byte, an f32 pooled probability), plus q and y in bf16.
    assert w.nbytes == 8 * 2048 * 277 + 2 * 2 * 32 * 128 == 4_554_752
    assert w.int8_ops == 2 * 2 * 32 * 2048 * 128
    assert dense.decode_attention(d, 4, 2048).nbytes == 4 * w.nbytes


def test_prefill_attention_by_hand():
    d = dims("mistral_7b_v02")
    w = dense.prefill_attention(d, [8192])
    pairs = 8192 * 8193 // 2
    assert w.bf16_flops == 4 * 128 * 32 * pairs == 549_822_922_752
    assert w.seconds() == pytest.approx(w.bf16_flops / 989e12)
    two = dense.prefill_attention(d, [100, 50])
    assert two.bf16_flops == 4 * 128 * 32 * (5050 + 1275)


def test_prefill_is_compute_bound_by_hand():
    d = dims("qwen2_7b")
    n = 7000
    linear = 4608 * 3584 + 3584 * 3584 + 3584 * 37888 + 18944 * 3584
    w = dense.prefill(d, [n])
    flops = 2 * n * linear * 28 + 4 * 128 * 28 * (n * (n + 1) // 2) * 28
    assert w.bf16_flops == flops
    assert w.int8_ops == 2 * 3584 * 152064
    assert w.seconds() > w.nbytes / roofline.PEAK_BYTES


def test_work_adds_and_scales():
    a = roofline.Work(1.0, 2.0, 3.0)
    assert (a + a * 2).nbytes == 9.0
    assert roofline.Work(int8_ops=roofline.PEAK_INT8_OPS).seconds() == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["mistral_7b_v02", "qwen2_7b"])
def test_the_readers_counts_cover_every_layer(name):
    """What the kernel readers read: each projection of a step at its own
    bound, every layer's attention."""
    d = dims(name)
    gemvs = [roofline.gemv(d, 4, i, o).seconds() * d.n_layer for i, o in dense.layer_linears(d)]
    assert dense.decode_gemv_seconds(d, 4) == pytest.approx(
        sum(gemvs) + roofline.gemv(d, 4, d.dim, d.vocab).seconds())
    assert dense.decode_attention_seconds(d, 4, 2048, 8) == pytest.approx(
        (dense.decode_attention(d, 4, 2048, 8) * d.n_layer).seconds())
    assert dense.prefill_attention_seconds(d, [8064] * 4) == pytest.approx(
        (dense.prefill_attention(d, [8064] * 4) * d.n_layer).seconds())
