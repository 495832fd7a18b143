"""The port's KV-cache machinery against the JAX package: quantized row
storage, heavy-hitter eviction over a run of decode steps (and its fused
step, K7), and SnapKV prompt compression. The JAX states are functional; the port's are updated
in place, so each step compares the port's state with the JAX result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.caches import base as JB
from cold_compress_tpu.caches import get_cache_strategy as jax_strategy
from cold_compress_tpu.caches.prompt_compression import (
    PromptCompressorHeavyHitter as JaxSnapKV,
)
from cold_compress_tpu.caches.prompt_compression import compress_prompt as jax_compress
from cold_compress_tpu.runtime.engine import build_cache_specs as jax_build_specs
from cold_compress_tpu.models.config import ModelConfig as JaxModelConfig

from cold_compress_tpu_torch.caches import base as TB
from cold_compress_tpu_torch.caches import (
    cache_memory_gb,
    compress_prompt,
    get_cache_strategy,
    get_prompt_compressor,
    reset_state,
)
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.runtime.engine import build_cache_specs, cache_compatibility


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quantize_rows_bytes_identical(bits):
    rng = np.random.RandomState(bits)
    x = rng.randn(2, 3, 7, 128).astype(np.float32) * 3
    x[0, 0, 0] = 0.25  # constant row: the 1e-6 scale floor
    qj, sj, zj = JB.quantize_rows(jnp.asarray(x), bits)
    qt, st, zt = TB.quantize_rows(_t(x), bits)
    assert qt.dtype == torch.uint8
    assert qt.numpy().tobytes() == np.asarray(qj).tobytes()
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    deq_j = JB.dequantize_rows(qj, sj, zj, bits, jnp.float32)
    deq_t = TB.dequantize_rows(qt, st, zt, bits, torch.float32)
    np.testing.assert_array_equal(deq_t.numpy(), np.asarray(deq_j))


SPEC_KW = dict(cache_strategy="heavy_hitter", max_cache_length=16,
               max_seq_length=64, global_tokens=2, recent_window=3, cache_bits=8)


def _same_state(ts, js):
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_array_equal(ts.cache_ct.numpy(), np.asarray(js.cache_ct))
    assert ts.k.numpy().tobytes() == np.asarray(js.k).tobytes()
    np.testing.assert_array_equal(ts.v_scales.numpy(), np.asarray(js.v_scales))
    for key in ("attn_num", "attn_denom", "attn_counter"):
        np.testing.assert_array_equal(ts.extra[key].numpy(), np.asarray(js.extra[key]))


@pytest.mark.parametrize("history_window,thresholding", [(1, False), (4, False), (1, True)])
def test_heavy_hitter_eviction_identical_over_decode_steps(history_window, thresholding):
    """Prefill-fill 10 slots, then 30 decode steps with numpy attention
    observations: every step evicts the same slot (pos/mask/counts equal),
    stores the same quantized bytes and keeps the same history. With
    thresholding the history counts 0/1 votes, so ties are everywhere."""
    B, KVH, D, P = 2, 2, 128, 10
    rng = np.random.RandomState(history_window)
    kw = dict(history_window_size=history_window, attn_thresholding=thresholding, **SPEC_KW)
    jspec = JB.CacheSpec(**kw)
    tspec = TB.CacheSpec(**kw)
    jstrat, tstrat = jax_strategy("heavy_hitter"), get_cache_strategy("heavy_hitter")
    js = jstrat.init(jspec, B, KVH, D)
    ts = tstrat.init(tspec, B, KVH, D, device="cpu")

    k = rng.randn(B, KVH, P, D).astype(np.float32)
    v = rng.randn(B, KVH, P, D).astype(np.float32)
    valid = np.ones((B, KVH, P), bool)
    valid[1, :, -2:] = False
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (B, KVH, P))
    js = JB.prefill_update(jstrat, js, jnp.asarray(pos), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(valid))
    TB.prefill_update(tstrat, ts, _t(pos), _t(k), _t(v), _t(valid))
    seed_attn = rng.rand(B, KVH, P).astype(np.float32)
    js = jstrat.update_state(jspec, js, None, jnp.asarray(seed_attn), is_prefill=True)
    tstrat.update_state(tspec, ts, None, _t(seed_attn), is_prefill=True)
    _same_state(ts, js)

    for step in range(30):
        ipos = P + step
        kr = rng.randn(B, KVH, 1, D).astype(np.float32)
        vr = rng.randn(B, KVH, 1, D).astype(np.float32)
        js, _, _, _ = JB.decode_update(jstrat, js, jnp.int32(ipos), jnp.asarray(kr),
                                       jnp.asarray(vr))
        TB.decode_update(tstrat, ts, ipos, _t(kr), _t(vr))
        attn = rng.dirichlet(np.ones(16), size=(B, KVH)).astype(np.float32)
        attn = attn * np.asarray(js.mask)  # empty slots get no mass
        if step % 7 == 3:
            attn[:] = np.round(attn * 8) / 8  # ties: argmin takes the first
        js = jstrat.update_state(jspec, js, ipos, jnp.asarray(attn), is_prefill=False)
        tstrat.update_state(tspec, ts, ipos, _t(attn), is_prefill=False)
        _same_state(ts, js)
    assert int(ts.cache_ct.min()) == 16


def _summary(rng, B, KVH, P, dyadic):
    obs = rng.rand(B, KVH, P).astype(np.float32)
    cum = rng.rand(B, KVH, P).astype(np.float32)
    if dyadic:  # many exact ties, summed exactly by any cumsum order
        obs = np.floor(obs * 4) / 4
    return {"obs_mean": obs, "cum_mean": cum}


@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("plen", [[97, 97], [97, 60]])
def test_compress_prompt_keep_indices_identical(dyadic, plen):
    """SnapKV selection: same kept positions (ties go to the lower index,
    as jax.lax.top_k does), same gathered K/V and seeded history."""
    B, KVH, P, D, C = 2, 2, 128, 8, 32
    rng = np.random.RandomState(int(dyadic) + plen[1])
    spec_kw = dict(cache_strategy="heavy_hitter", max_cache_length=C,
                   max_seq_length=P, global_tokens=4,
                   prompt_compression_strategy="heavy_hitter")
    jspec, tspec = JB.CacheSpec(**spec_kw), TB.CacheSpec(**spec_kw)
    k = rng.randn(B, KVH, P, D).astype(np.float32)
    v = rng.randn(B, KVH, P, D).astype(np.float32)
    plen_a = np.asarray(plen, np.int32)
    valid = np.arange(P)[None, :] < plen_a[:, None]
    s = _summary(rng, B, KVH, P, dyadic)
    ipos = np.arange(P, dtype=np.int32)
    ref = jax_compress(JaxSnapKV, jspec, jnp.asarray(ipos), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(valid), jnp.asarray(plen_a),
                       summary={key: jnp.asarray(a) for key, a in s.items()})
    got = compress_prompt(get_prompt_compressor("heavy_hitter"), tspec, _t(ipos), _t(k),
                          _t(v), _t(valid), _t(plen_a),
                          summary={key: _t(a) for key, a in s.items()})
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_cache_specs_and_registry_match_jax():
    """Per-layer specs of the main path's cache options, and the checks."""
    kw = {"cache_strategy": ["heavy_hitter"], "max_cache_length": [0.25],
          "prompt_compression_strategy": ["heavy_hitter"], "global_tokens": 4,
          "recent_window": 10, "cache_bits": 8}
    ref = jax_build_specs(JaxModelConfig.from_name("TestKernel"), kw, 8192)
    got = build_cache_specs(ModelConfig.from_name("TestKernel"), kw, 8192)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for field in ("cache_strategy", "max_cache_length", "max_seq_length",
                      "global_tokens", "recent_window", "cache_bits",
                      "prompt_compression_strategy", "history_window_size"):
            assert getattr(g, field) == getattr(r, field), field
    assert got[0].max_cache_length == 2048
    cache_compatibility({"max_cache_length": [0.25], "cache_strategy": ["heavy_hitter"],
                         "prompt_compression_strategy": ["heavy_hitter"]})
    with pytest.raises(ValueError):
        cache_compatibility({"max_cache_length": [0.25], "cache_strategy": ["heavy_hitter"],
                             "prompt_compression_strategy": ["full"]})
    with pytest.raises(ValueError, match="nope"):
        get_cache_strategy("nope")
    with pytest.raises(ValueError, match="nope"):
        get_prompt_compressor("nope")


def test_reset_state_and_memory():
    spec = TB.CacheSpec(**SPEC_KW)
    st = get_cache_strategy("heavy_hitter").init(spec, 1, 8, 128, device="cpu")
    st.pos.fill_(3)
    st.extra["attn_num"].fill_(1.0)
    st.k_scales.fill_(2.0)
    reset_state(st)
    assert int(st.pos.max()) == -1 and float(st.extra["attn_num"].abs().sum()) == 0
    assert float(st.k_scales.min()) == 1e-6 or np.isclose(float(st.k_scales.min()), 1e-6)
    jst = jax_strategy("heavy_hitter").init(JB.CacheSpec(**SPEC_KW), 1, 8, 128)
    assert cache_memory_gb(st) == pytest.approx(JB.cache_memory_gb(jst))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_evict_plain_matches_tpu_kernel_bit_for_bit(seed):
    """K7's plain version against fused_hh_evict in interpret mode: the same
    slot per head and the same zeroed history, bit for bit. Seed 1 has
    dyadic averages (exact ties: the first index wins), seed 2 per-lane
    positions and empty slots."""
    from cold_compress_tpu.ops.pallas_evict import fused_hh_evict

    from cold_compress_tpu_torch.ops import evict

    rng = np.random.RandomState(seed)
    B, H, C = 2, 3, 256
    num = rng.rand(B, H, C).astype(np.float32)
    if seed == 1:
        num = np.floor(num * 8) / 4
    denom = rng.randint(0, 6, size=(B, H, C)).astype(np.int32)
    pos = np.stack([rng.permutation(C) for _ in range(B * H)]).reshape(B, H, C).astype(np.int32)
    if seed == 2:
        pos[0, :, -9:] = -1
    ipos = np.array([C + 2, C - 40], np.int32)
    idx_j, num_j, den_j = fused_hh_evict(
        jnp.asarray(num), jnp.asarray(denom), jnp.asarray(pos), jnp.asarray(ipos),
        global_tokens=4, recent_window=10, interpret=True,
    )
    tn, td = _t(num), _t(denom)
    idx = evict.hh_evict(tn, td, _t(pos), _t(ipos)[:, None, None], global_tokens=4,
                         recent_window=10)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert tn.numpy().tobytes() == np.asarray(num_j).tobytes()
    np.testing.assert_array_equal(td.numpy(), np.asarray(den_j))
