"""Decode's fused rotate-and-insert (``ops/evict.py::hh_evict_insert``):
which caches take it, its plain version against the eager composite it
replaces (rope, then the heavy-hitter ``decode_update``) bit for bit, and
decode steps through it against steps without it, on the CPU and on the
card (marked ``cuda``, skipped without one). The kernel itself is held to
the plain version on the card in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from cold_compress_tpu_torch.caches import HeavyHitterCache, base, get_cache_strategy
from cold_compress_tpu_torch.caches import heavy_hitter
from cold_compress_tpu_torch.models import transformer
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.models.rope import apply_rotary_emb, precompute_freqs_cis
from cold_compress_tpu_torch.ops import evict
from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params
from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model, params_from_flat
from torch_hh_insert import assert_same_cache, bits, hh_kv8_state
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("strategy,cache_bits,head_dim", [
    ("heavy_hitter", 8, 128),
    ("hybrid", 8, 128),
    ("heavy_hitter", 2, 128),
    ("full", 8, 128),
    ("random", 8, 128),
    ("recent_global", 8, 128),
    ("keep_it_odd", 8, 128),
    ("heavy_hitter", 8, 64),
    ("heavy_hitter", 8, 256),
])
def test_only_one_slot_heavy_hitter_kv8_at_heads_of_128_fuses(strategy, cache_bits, head_dim):
    """The strategies, precisions and head sizes that
    ``test_decode_step_routes_per_cache`` does not drive: hybrid (a
    heavy-hitter subclass with its own insert), kv2, the other strategies,
    heads of 64 and 256."""
    spec = base.CacheSpec(cache_strategy=strategy, cache_bits=cache_bits)
    want = (strategy, cache_bits, head_dim) == ("heavy_hitter", 8, 128)
    assert get_cache_strategy(strategy).fuses_rotate_insert(spec, head_dim) == want


@pytest.mark.parametrize("C", [64, 61])
@pytest.mark.parametrize("KVH,G", [(8, 4), (4, 7)])
@pytest.mark.parametrize("B", [1, 4])
def test_plain_insert_equals_rope_then_decode_update(B, KVH, G, C):
    """Three steps, each lane at its own position: the same q, idx and
    every cache tensor, bit for bit, as ``apply_rotary_emb`` on q and k
    followed by the heavy-hitter ``decode_update``."""
    seed = B * 100 + KVH * 10 + C
    g = torch.Generator().manual_seed(seed + 1)
    H, hd = KVH * G, 128
    fused, eager = hh_kv8_state("cpu", B, KVH, C, seed), hh_kv8_state("cpu", B, KVH, C, seed)
    rope = precompute_freqs_cis(2 * C + 64, hd, 10000.0)
    strat = get_cache_strategy("heavy_hitter")
    for step in range(3):
        ipos = C + step + 5 * torch.arange(B, dtype=torch.int32)
        freqs = rope[ipos.long()][:, None]
        y = (3 * torch.randn((B, 1, (H + 2 * KVH) * hd), generator=g)).to(torch.bfloat16)
        q, idx = evict.hh_evict_insert(y, freqs, fused, ipos, n_head=H, n_kv_head=KVH)
        q_ref = apply_rotary_emb(y[..., :H * hd].reshape(B, 1, H, hd), freqs).transpose(1, 2)
        k_ref = apply_rotary_emb(y[..., H * hd:(H + KVH) * hd].reshape(B, 1, KVH, hd), freqs)
        v_ref = y[..., (H + KVH) * hd:].reshape(B, 1, KVH, hd)
        before = eager.pos.clone()
        strat.decode_update(eager, ipos, k_ref.transpose(1, 2), v_ref.transpose(1, 2))
        assert q.shape == (B, H, 1, hd) and torch.equal(bits(q), bits(q_ref))
        moved = (eager.pos != before).nonzero()[:, 2].reshape(B, KVH)
        assert torch.equal(idx.long(), moved)
        assert_same_cache(fused, eager)
    # Even lanes filled their empty slots first; the counts say so.
    assert fused.cache_ct[0].tolist() == [C - 2] * KVH


def _model(dev):
    """TestKernel (heads of 128) with int4 weights."""
    cfg = ModelConfig.from_name("TestKernel")
    return build_model(cfg, params_from_flat(random_quantized_params(cfg, seed=0), dev), dev,
                       max_positions=512)


@pytest.mark.parametrize("strategy,cache_bits,window,routed", [
    ("heavy_hitter", 8, 1, True),
    ("heavy_hitter", 4, 1, False),
    ("heavy_hitter", None, 1, False),
    ("heavy_hitter", 8, 3, False),
    ("debug_heavy_hitter", 8, 1, False),
    ("l2", 8, 1, False),
])
def test_decode_step_routes_per_cache(monkeypatch, strategy, cache_bits, window, routed):
    """``decode_step`` calls the fused insert once per layer exactly
    where the cache's strategy takes it."""
    model = _model("cpu")
    cfg = model.cfg
    specs = build_cache_specs(cfg, {
        "cache_strategy": [strategy], "max_cache_length": [64],
        "prompt_compression_strategy": ["recent_global"], "global_tokens": 4,
        "recent_window": 10, "cache_bits": cache_bits, "history_window_size": window}, 512)
    caches = transformer.init_caches(cfg, specs, 1, device="cpu")
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return evict.hh_evict_insert(*args, **kw)

    monkeypatch.setattr(heavy_hitter, "hh_evict_insert", spy)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(2, 500, (1, 40)))
    transformer.prefill(model, caches, tokens, 40)
    transformer.decode_step(model, caches, torch.tensor([7]), 40)
    assert len(calls) == (cfg.n_layer if routed else 0)


@pytest.mark.parametrize("device,B", [
    ("cpu", 1), ("cpu", 3),
    pytest.param("cuda", 1, marks=pytest.mark.cuda),
    pytest.param("cuda", 3, marks=pytest.mark.cuda),
])
def test_decode_steps_through_route_equal_steps_without(monkeypatch, device, B):
    """TestKernel, kv8 heavy hitter at C = 128 with SnapKV: four decode
    steps through the fused insert (the kernel on the card, its plain
    version on the CPU) and four through the eager composite (the route
    turned off), from the same prefilled caches (lanes of 300, 200 and 100
    tokens in a 512 bucket: the last has empty slots): the same logits and
    every cache tensor, bit for bit."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device(device)
    model = _model(dev)
    cfg = model.cfg
    specs = build_cache_specs(cfg, {
        "cache_strategy": ["heavy_hitter"], "max_cache_length": [128],
        "prompt_compression_strategy": ["heavy_hitter"], "global_tokens": 4,
        "recent_window": 10, "cache_bits": 8}, 512)
    lens = [300, 200, 100][:B]
    tokens = torch.from_numpy(np.random.RandomState(2).randint(2, 500, (B, 512))).to(dev)
    caches = transformer.init_caches(cfg, specs, B, device=dev)
    transformer.prefill(model, caches, tokens, torch.tensor(lens, dtype=torch.int32, device=dev))
    start = [[t.clone() for t in c.tensors()] for c in caches]
    out = {}
    for routed in (True, False):
        for c, saved in zip(caches, start):
            for t, s in zip(c.tensors(), saved):
                t.copy_(s)
        if not routed:
            monkeypatch.setattr(HeavyHitterCache, "fuses_rotate_insert",
                                classmethod(lambda cls, spec, head_dim: False))
        before = dict(evict.LAUNCHES)
        logits = []
        for step in range(4):
            pos = torch.tensor(lens, dtype=torch.int32, device=dev) + step
            tok = torch.tensor([5 + step + b for b in range(B)], device=dev)
            logits.append(transformer.decode_step(model, caches, tok, pos))
        if device == "cuda":
            fused = evict.LAUNCHES["hh_evict_insert"] - before["hh_evict_insert"]
            alone = evict.LAUNCHES["hh_evict"] - before["hh_evict"]
            assert (fused, alone) == ((4 * cfg.n_layer, 0) if routed else (0, 4 * cfg.n_layer))
        out[routed] = (logits, [t.clone() for c in caches for t in c.tensors()])
    for a, b in zip(out[True][0] + out[True][1], out[False][0] + out[False][1]):
        assert torch.equal(bits(a), bits(b))
    assert int(caches[0].cache_ct.min()) == (128 if B == 1 else 104)
