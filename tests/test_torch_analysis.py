"""The port's attention-loss analysis caches (``debug_<strategy>``) against
the JAX package's: per-step losses, the shadow cache's kept positions and
the statistics ``get_cache_stats`` reports; the loss buffer's sentinel on
reset, and ``generate``'s direct-fill bound for the outer full cache."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.models import transformer as JT
from cold_compress_tpu.runtime.engine import _flatten
from cold_compress_tpu.runtime.engine import build_cache_specs as jax_build_specs
from cold_compress_tpu.runtime.generate import generate as jax_generate
from cold_compress_tpu.runtime.stats import get_cache_stats as jax_stats
from cold_compress_tpu.runtime.stats import unstack_caches

from cold_compress_tpu_torch.caches import cache_memory_gb, get_cache_strategy
from cold_compress_tpu_torch.models import transformer as TT
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model, params_from_flat
from cold_compress_tpu_torch.runtime.generate import generate, reset_caches
from cold_compress_tpu_torch.runtime.stats import get_cache_stats
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MAX_SEQ = 96
PROMPT = list(range(1, 41))


def _kw(inner, budget=24):
    return {
        "cache_strategy": [f"debug_{inner}"], "max_cache_length": [budget],
        "prompt_compression_strategy": ["heavy_hitter" if inner == "heavy_hitter"
                                        else "recent_global"],
        "global_tokens": 2, "recent_window": 4,
    }


@pytest.fixture(scope="module")
def port_tiny(tiny_model):
    jcfg, jparams, rope = tiny_model
    cfg = ModelConfig.from_name("TestTiny")
    model = build_model(cfg, params_from_flat(_flatten(jparams), "cpu"), "cpu",
                        max_positions=MAX_SEQ)
    return cfg, model


def _port_caches(cfg, kw):
    return TT.init_caches(cfg, build_cache_specs(cfg, kw, MAX_SEQ), 1, torch.float32,
                          device="cpu")


@pytest.mark.parametrize("inner", ["heavy_hitter", "recent_global"])
def test_debug_cache_matches_jax(tiny_model, port_tiny, inner):
    """TestTiny in f32, 16 greedy tokens over a shadow of 24 slots: the same
    tokens, the same per-step losses (f32 noise) and shadow positions in
    every layer, the same statistics; the outer cache keeps everything."""
    jcfg, jparams, rope = tiny_model
    cfg, model = port_tiny
    kw = _kw(inner)
    jcaches = JT.init_caches(jcfg, jax_build_specs(jcfg, kw, MAX_SEQ), 1, jnp.float32)
    jseq, _, jcaches = jax_generate(jcfg, jparams, rope, jcaches, PROMPT, 16)
    caches = _port_caches(cfg, kw)
    seq, _, caches = generate(model, caches, PROMPT, 16)
    assert seq == jseq
    for layer, (c, jc) in enumerate(zip(caches, unstack_caches(jcaches))):
        ctr = int(c.extra["attention_loss_ctr"])
        assert ctr == int(jc.extra["attention_loss_ctr"]) == 15
        losses = c.extra["attention_losses"].numpy()
        np.testing.assert_allclose(losses, np.asarray(jc.extra["attention_losses"]),
                                   rtol=1e-4, atol=1e-6, err_msg=f"layer {layer}")
        assert np.all(losses[ctr:] == -1.0) and np.all(losses[:ctr] >= -1e-5)
        shadow, jshadow = c.extra["shadow"], jc.extra["shadow"]
        np.testing.assert_array_equal(shadow.pos.numpy(), np.asarray(jshadow.pos))
        assert int(shadow.cache_ct.max()) == 24 and shadow.spec.cache_strategy == inner
        assert int(c.cache_ct[0, 0]) == len(PROMPT) + 15 and c.spec.max_cache_length == MAX_SEQ
        assert c.k.dtype == torch.float32 and c.spec.cache_bits is None
    stats, ref = get_cache_stats(caches, len(PROMPT), 16), jax_stats(jcaches, len(PROMPT), 16)
    assert list(stats) == list(ref)
    assert "attention_loss_avg" in stats
    for key, val in ref.items():
        assert stats[key] == pytest.approx(val, rel=1e-4, abs=1e-6), key


def test_debug_registry_reset_and_memory(port_tiny):
    """``debug_<name>`` resolves for any ported name (memoised), an unknown
    inner name raises; reset restores the loss buffer's -1 sentinel and the
    shadow's empty slots; the memory count includes the shadow."""
    cls = get_cache_strategy("debug_l2")
    assert cls.name == "debug_l2" and cls.inner_strategy.name == "l2"
    assert get_cache_strategy("debug_l2") is cls
    with pytest.raises(ValueError):
        get_cache_strategy("debug_bogus")
    cfg, model = port_tiny
    caches = _port_caches(cfg, _kw("heavy_hitter"))
    generate(model, caches, PROMPT, 4)
    c = caches[0]
    outer_only = sum(t.numel() * t.element_size() for t in (c.k, c.v, c.pos, c.mask))
    assert cache_memory_gb(c) * 1024 ** 3 > outer_only + c.extra["shadow"].k.numel() * 4
    reset_caches(caches)
    assert bool((c.extra["attention_losses"] == -1.0).all())
    assert int(c.extra["attention_loss_ctr"]) == 0
    assert bool((c.extra["shadow"].pos == -1).all()) and int(c.cache_ct.sum()) == 0


def test_prompt_longer_than_debug_outer_cache_raises(port_tiny):
    """The outer cache of ``debug_*`` is filled directly, so the prefill
    bucket is capped at its length; a longer prompt raises (it would not
    fit) instead of writing past the cache."""
    cfg, model = port_tiny
    caches = TT.init_caches(cfg, build_cache_specs(cfg, _kw("recent_global"), 48), 1,
                            torch.float32, device="cpu")
    assert caches[0].spec.max_cache_length == 48
    with pytest.raises(ValueError, match="direct-fill"):
        generate(model, caches, list(range(1, 50)), 4)
    seq, _, _ = generate(model, reset_caches(caches), list(range(1, 40)), 4)  # bucket 64 -> 48
    assert len(seq) == 43
