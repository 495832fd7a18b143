"""The port's cache strategies, prompt compressors, layer patterns and cache
statistics against the JAX package, with exact equality of what each keeps.

The fixtures are random f32 keys: no two slots tie in L2 norm, so the l2
strategy's order does not depend on the last bit of a norm (the norms
themselves are compared to f32 rounding). The other strategies depend on
positions and, for ``random``, on counter-based draws that the port
reproduces bit for bit (``utils/prng.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.caches import base as JB
from cold_compress_tpu.caches import get_cache_strategy as jax_strategy
from cold_compress_tpu.caches import patterns as JP
from cold_compress_tpu.caches.prompt_compression import compress_prompt as jax_compress
from cold_compress_tpu.caches.prompt_compression import get_prompt_compressor as jax_compressor
from cold_compress_tpu.models.config import ModelConfig as JaxModelConfig
from cold_compress_tpu.ops.attention import gqa_attention as jax_gqa
from cold_compress_tpu.runtime.engine import build_cache_specs as jax_build_specs
from cold_compress_tpu.runtime.stats import get_cache_stats as jax_stats

from cold_compress_tpu_torch.caches import (
    CACHE_STRATEGIES,
    CacheStrategy,
    compress_prompt,
    compression_ratio,
    get_cache_strategy,
    get_prompt_compressor,
    register_strategy,
)
from cold_compress_tpu_torch.bench import cache_kwargs as bench_cache_kwargs
from cold_compress_tpu_torch.caches import base as TB
from cold_compress_tpu_torch.caches import patterns as TP
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.ops.attention import gqa_attention
from cold_compress_tpu_torch.runtime.engine import build_cache_specs
from cold_compress_tpu_torch.runtime.stats import get_cache_stats


def _t(a):
    return torch.from_numpy(np.array(a))


def _spec_kw(strategy, bits):
    return dict(cache_strategy=strategy, max_cache_length=16, max_seq_length=64,
                global_tokens=2, recent_window=3, cache_bits=bits)


def _same_state(ts, js, step):
    for field in ("pos", "mask", "cache_ct"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(), np.asarray(getattr(js, field)),
                                      err_msg=f"{field} at step {step}")
    assert ts.k.numpy().tobytes() == np.asarray(js.k).tobytes(), step
    assert ts.v.numpy().tobytes() == np.asarray(js.v).tobytes(), step
    assert set(ts.extra) == set(js.extra)
    for key, val in ts.extra.items():
        # Norms are f32 reductions whose order may differ in the last bit.
        np.testing.assert_allclose(val.numpy(), np.asarray(js.extra[key]), rtol=1e-6,
                                   err_msg=f"{key} at step {step}")


@pytest.mark.parametrize("bits", [None, 4, 2])
@pytest.mark.parametrize("strategy", ["full", "recent_global", "random", "l2", "keep_it_odd"])
def test_strategy_evicts_the_same_slots_over_decode_steps(strategy, bits):
    """Prefill-fill 10 slots (two padded in one lane), then 30 decode steps
    of random K/V rows: every step the port's ``decode_update`` (its
    ``eviction_idx`` and fill hooks) claims the same slot per head as the
    JAX package, stores the same bytes and keeps the same extra state
    (``rng_counter``, ``key_norm``)."""
    B, KVH, D, P = 2, 2, 128, 10
    rng = np.random.RandomState(len(strategy) * 7 + (bits or 16))
    jspec, tspec = JB.CacheSpec(**_spec_kw(strategy, bits)), TB.CacheSpec(**_spec_kw(strategy, bits))
    jstrat, tstrat = jax_strategy(strategy), get_cache_strategy(strategy)
    js = jstrat.init(jspec, B, KVH, D, dtype=jnp.float32)
    ts = tstrat.init(tspec, B, KVH, D, dtype=torch.float32, device="cpu")

    k = rng.randn(B, KVH, P, D).astype(np.float32) * rng.uniform(0.5, 2, (B, KVH, P, 1))
    v = rng.randn(B, KVH, P, D).astype(np.float32)
    valid = np.ones((B, KVH, P), bool)
    valid[1, :, -2:] = False
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (B, KVH, P))
    js = JB.prefill_update(jstrat, js, jnp.asarray(pos), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(valid))
    TB.prefill_update(tstrat, ts, _t(pos), _t(k), _t(v), _t(valid))
    _same_state(ts, js, "prefill")
    for step in range(30):
        ipos = P + step
        kr = rng.randn(B, KVH, 1, D).astype(np.float32) * rng.uniform(0.5, 2, (B, KVH, 1, 1))
        vr = rng.randn(B, KVH, 1, D).astype(np.float32)
        js, _, _, _ = JB.decode_update(jstrat, js, jnp.int32(ipos), jnp.asarray(kr),
                                       jnp.asarray(vr))
        TB.decode_update(tstrat, ts, ipos, _t(kr), _t(vr))
        _same_state(ts, js, step)
    assert int(ts.cache_ct.min()) == 16
    if strategy == "random":
        assert int(ts.extra["rng_counter"]) == 30


@pytest.mark.parametrize("plen", [[97, 97], [97, 60]])
@pytest.mark.parametrize("name", ["random", "recent_global", "l2", "keep_it_odd"])
def test_prompt_compressor_keeps_the_same_positions(name, plen):
    """Kept positions, gathered K/V and validity equal to the JAX
    compressor's, per lane prompt lengths included (``random`` folds in
    their sum)."""
    B, KVH, P, D, C = 2, 2, 128, 16, 32
    rng = np.random.RandomState(len(name) + plen[1])
    spec_kw = dict(cache_strategy=name, max_cache_length=C, max_seq_length=P,
                   global_tokens=4, recent_window=10, prompt_compression_strategy=name)
    jspec, tspec = JB.CacheSpec(**spec_kw), TB.CacheSpec(**spec_kw)
    k = rng.randn(B, KVH, P, D).astype(np.float32)
    v = rng.randn(B, KVH, P, D).astype(np.float32)
    plen_a = np.asarray(plen, np.int32)
    valid = np.arange(P)[None, :] < plen_a[:, None]
    ipos = np.arange(P, dtype=np.int32)
    ref = jax_compress(jax_compressor(name), jspec, jnp.asarray(ipos), jnp.asarray(k),
                       jnp.asarray(v), jnp.asarray(valid), jnp.asarray(plen_a))
    got = compress_prompt(get_prompt_compressor(name), tspec, _t(ipos), _t(k), _t(v),
                          _t(valid), _t(plen_a))
    assert got[-1] is None and ref[-1] is None
    for g, r in zip(got[:-1], ref[:-1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    kept = got[0].numpy()
    assert np.all(kept[0, :, :4] == np.arange(4))  # the global prefix stays
    if name != "random":
        recent = np.arange(plen[1] - 10, plen[1])
        assert np.all(kept[1, :, -10:] == recent)  # so does the recent window


@pytest.mark.parametrize("n_layer,length", [(32, 2048), (32, 256), (2, 128), (8, 1000)])
@pytest.mark.parametrize("decreasing", [True, False])
def test_pyramid_ramp_matches_jax(n_layer, length, decreasing):
    """PyramidKV lengths, with the minimum redistributed; per-layer lengths
    need not be multiples of 128 (the decode kernel masks a ragged chunk)."""
    ref = JP.apply_pyramid_pattern(length, 8192, n_layer, decreasing=decreasing)
    assert TP.apply_pyramid_pattern(length, 8192, n_layer, decreasing=decreasing) == ref


@pytest.mark.parametrize("config", [
    {"cache_strategy": ["heavy_hitter"], "prompt_compression_strategy": ["heavy_hitter"],
     "cache_length_pattern": "pyramid", "global_tokens": 4, "recent_window": 10,
     "history_window_size": 400, "max_cache_length": [0.25]},
    {"cache_strategy": ["heavy_hitter"], "prompt_compression_strategy": ["heavy_hitter"],
     "cache_length_pattern": "funnel", "global_tokens": 4, "recent_window": 10,
     "history_window_size": 400, "max_cache_length": [0.25]},
    {"cache_strategy": ["recent_global", "heavy_hitter"],
     "prompt_compression_strategy": ["recent_global", "heavy_hitter"],
     "cache_strategy_pattern": "repeat", "global_tokens": 4, "max_cache_length": [0.5],
     "cache_bits": 4},
    {"cache_strategy": ["l2"], "prompt_compression_strategy": ["l2"],
     "max_cache_length": [0.1], "recent_window": 0.2, "cache_bits": 2},
    dict(bench_cache_kwargs("hybrid", 0.25, 4, 8), min_recovery_frac=0.8),
], ids=["heavy_hitter_pyramid", "heavy_hitter_funnel", "local_global", "l2_fractional",
        "hybrid_fastgen"])
def test_cache_specs_match_jax(config):
    """``cache_configs/*.yaml`` shapes: per-layer specs equal field by field."""
    ref = jax_build_specs(JaxModelConfig.from_name("Meta-Llama-3-8B-Instruct"), config, 8192)
    got = build_cache_specs(ModelConfig.from_name("Meta-Llama-3-8B-Instruct"), config, 8192)
    assert len(got) == len(ref) == 32
    for g, r in zip(got, ref):
        for field in ("cache_strategy", "max_cache_length", "max_seq_length", "global_tokens",
                      "recent_window", "cache_bits", "prompt_compression_strategy",
                      "history_window_size", "attn_thresholding", "min_recovery_frac",
                      "token_ids_special", "token_ids_punc"):
            assert getattr(g, field) == getattr(r, field), field
        assert [vars(e) for e in g.hybrid_strategies] == [vars(e) for e in r.hybrid_strategies]
    lengths = [s.max_cache_length for s in got]
    if config.get("cache_length_pattern") == "pyramid":
        assert lengths[0] > lengths[-1] and any(n % 128 for n in lengths)
    if config.get("cache_length_pattern") == "funnel":
        assert lengths[0] < lengths[-1]


def test_registry_and_strategies_not_ported():
    assert set(CACHE_STRATEGIES) == {"full", "random", "recent_global", "l2", "keep_it_odd",
                                     "heavy_hitter"}
    # hybrid and the debug_* analysis wrappers resolve outside the dict, as
    # in the JAX package.
    assert get_cache_strategy("hybrid").name == "hybrid"
    assert get_cache_strategy("debug_heavy_hitter").inner_strategy.name == "heavy_hitter"
    with pytest.raises(ValueError, match="Invalid cache strategy"):
        get_cache_strategy("nope")
    with pytest.raises(ValueError, match="Invalid cache strategy"):
        get_cache_strategy("debug_nope")

    @register_strategy
    class Oldest(CacheStrategy):
        name = "oldest_for_test"

        @staticmethod
        def token_importances(spec, state, input_pos):
            return state.pos.float()

    try:
        assert get_cache_strategy("oldest_for_test") is Oldest
        spec = TB.CacheSpec(**_spec_kw("oldest_for_test", None))
        st = Oldest.init(spec, 1, 1, 128, device="cpu")
        st.pos[:] = torch.arange(16, 0, -1, dtype=torch.int32)
        st.pos[0, 0, 5] = -1
        # The empty slot first, then (without it) the oldest past the globals.
        assert Oldest.eviction_idx(spec, st, torch.tensor([[[20]]])).tolist() == [[5]]
        st.pos[0, 0, 5] = 11
        assert Oldest.eviction_idx(spec, st, torch.tensor([[[20]]])).tolist() == [[15]]
    finally:
        CACHE_STRATEGIES.pop("oldest_for_test")


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_compression_ratio_and_stats_match_jax(bits):
    """Quantization-aware compression ratio per layer, its average and the
    caches' memory, as ``runtime/stats.py::get_cache_stats`` reports them."""
    rng = np.random.RandomState(bits or 16)
    spec_kw = _spec_kw("recent_global", bits)
    jst, tst = [], []
    for layer in range(3):
        js = jax_strategy("recent_global").init(JB.CacheSpec(**spec_kw), 2, 2, 128)
        ts = get_cache_strategy("recent_global").init(TB.CacheSpec(**spec_kw), 2, 2, 128,
                                                      device="cpu")
        ct = rng.randint(0, 17, size=(2, 2)).astype(np.int32)
        js = js.replace(cache_ct=jnp.asarray(ct))
        ts.cache_ct.copy_(_t(ct))
        jst.append(js)
        tst.append(ts)
        np.testing.assert_allclose(float(compression_ratio(ts, 40)),
                                   float(JB.compression_ratio(js, 40)), rtol=1e-6)
    ref = jax_stats(jst, 30, 10)
    got = get_cache_stats(tst, 30, 10)
    assert set(got) == set(ref)
    for key, val in ref.items():
        assert got[key] == pytest.approx(val, rel=1e-6), key


@pytest.mark.parametrize("top_k", [0.5, 0.1, 1.0])
def test_gqa_attention_top_k_matches_jax(top_k):
    """Decode attention over the top-scored share of the slots (masked
    slots never count): the same output and pooled probabilities."""
    rng = np.random.RandomState(int(top_k * 10))
    B, KVH, G, S, D = 2, 2, 3, 40, 128
    q = rng.randn(B, KVH * G, 1, D).astype(np.float32)
    k = rng.randn(B, KVH, S, D).astype(np.float32)
    v = rng.randn(B, KVH, S, D).astype(np.float32)
    mask = rng.rand(B, KVH, 1, 1, S) > 0.2
    ref_out, ref_attn = jax_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                mask=jnp.asarray(mask), return_attn=True, attn_top_k=top_k)
    out, attn = gqa_attention(_t(q), _t(k), _t(v), mask=_t(mask), return_attn=True,
                              attn_top_k=top_k)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), rtol=1e-5, atol=1e-7)
