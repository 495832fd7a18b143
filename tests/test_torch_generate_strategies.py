"""``generate()`` of the port against the JAX package's over the cache
strategies and precisions of ``bench.py`` and ``cache_configs/*.yaml``:
TestKernel (head_dim 128, so the port takes its decode-attention and
flash-prefill plain versions), f32 dense weights handed over through the
checkpoint key scheme, a 300-token prompt compressed to a quarter of 512
slots, then 16 teacher-forced tokens.

What each side keeps depends on positions alone for ``recent_global``,
``random`` (the same counter-based draws), ``keep_it_odd`` and ``full``:
the kept positions must be equal in every layer. ``l2`` ranks key norms;
f32 weights keep both sides' keys within f32 noise of each other and the
fixture has no near-tie, so its positions must be equal too. Heavy-hitter
histories can near-tie (PERF.md, ROADMAP section 3), so the layers they
rule are held by probabilities only.

Tolerance on the emitted probabilities: 3% relative. The port rounds q, K,
V and the probabilities to bf16 in decode attention, as the TPU kernel
does; JAX's XLA path on the CPU keeps f32 (PERF.md). A 2-bit cache moves
the scores further on both sides alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.models import transformer as JT
from cold_compress_tpu.models.config import ModelConfig as JaxModelConfig
from cold_compress_tpu.runtime.engine import _flatten
from cold_compress_tpu.runtime.engine import build_cache_specs as jax_build_specs
from cold_compress_tpu.runtime.generate import generate as jax_generate
from cold_compress_tpu.runtime.stats import unstack_caches

from cold_compress_tpu_torch.models import transformer as TT
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.ops import kernel_launches
from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model, params_from_flat
from cold_compress_tpu_torch.runtime.generate import generate

PROMPT = np.random.RandomState(0).randint(2, 500, size=300).tolist()
FORCED = np.random.RandomState(1).randint(2, 500, size=16).tolist()
MAX_SEQ = 512
PROBS_RTOL = 3e-2


def _kw(strategy, bits, **extra):
    """``bench.py``'s cache options for one strategy."""
    compressor = {"heavy_hitter": "heavy_hitter", "full": "full"}.get(strategy, "recent_global")
    kw = {
        "cache_strategy": [strategy],
        "max_cache_length": [1.0 if strategy == "full" else 0.25],
        "prompt_compression_strategy": [compressor],
        "global_tokens": 4,
        "recent_window": 10,
        "cache_bits": bits,
    }
    kw.update(extra)
    return kw


@pytest.fixture(scope="module")
def models():
    jcfg = JaxModelConfig.from_name("TestKernel")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = ModelConfig.from_name("TestKernel")
    # The JAX package's XLA path attends over dequantized K/V: the port's
    # dequantizing branch (its kv8 default is the TPU kernel's i8dot).
    model = build_model(cfg, params_from_flat(_flatten(jparams), "cpu"), "cpu",
                        max_positions=MAX_SEQ, attn_i8dot=False)
    return jcfg, jparams, JT.make_rope_table(jcfg), cfg, model


def _run_both(models, kw):
    jcfg, jparams, rope, cfg, model = models
    jcaches = JT.init_caches(jcfg, jax_build_specs(jcfg, kw, MAX_SEQ), 1, jnp.float32)
    _, jinfo, jcaches = jax_generate(jcfg, jparams, rope, jcaches, PROMPT, len(FORCED),
                                     prefill_bucket=MAX_SEQ, next_tokens=FORCED)
    caches = TT.init_caches(cfg, build_cache_specs(cfg, kw, MAX_SEQ), 1, torch.float32,
                            device="cpu")
    before = kernel_launches()
    seq, info, caches = generate(model, caches, PROMPT, len(FORCED), prefill_bucket=MAX_SEQ,
                                 next_tokens=FORCED)
    assert kernel_launches() == before  # CPU tensors: plain versions only
    assert seq == PROMPT + FORCED
    e, e_ref = np.asarray(info["emitted_probs"]), np.asarray(jinfo["emitted_probs"])
    np.testing.assert_allclose(e, e_ref, rtol=PROBS_RTOL)
    f, f_ref = np.asarray(info["final_probs"]), np.asarray(jinfo["final_probs"])
    np.testing.assert_allclose(f, f_ref, rtol=PROBS_RTOL, atol=1e-6)
    pos = [c.pos.numpy() for c in caches]
    pos_ref = [np.asarray(c.pos) for c in unstack_caches(jcaches)]
    return pos, pos_ref


@pytest.mark.parametrize("bits", [None, 4, 2], ids=["kv16", "kv4", "kv2"])
@pytest.mark.parametrize("strategy", ["recent_global", "random", "l2", "keep_it_odd", "full"])
def test_generate_keeps_the_same_positions(models, strategy, bits):
    pos, pos_ref = _run_both(models, _kw(strategy, bits))
    for layer, (p, r) in enumerate(zip(pos, pos_ref)):
        np.testing.assert_array_equal(p, r, err_msg=f"layer {layer}")
    if strategy == "full":
        assert int((pos[0] >= 0).sum()) == len(PROMPT) + len(FORCED) - 1
    else:
        assert pos[0].shape[-1] == MAX_SEQ // 4 and int(pos[0].max()) == len(PROMPT) + 14


def test_generate_local_global(models):
    """``cache_configs/local_global.yaml``: recent_global and heavy_hitter
    layers alternate (``repeat``), at a kv4 cache."""
    kw = {"cache_strategy": ["recent_global", "heavy_hitter"],
          "prompt_compression_strategy": ["recent_global", "heavy_hitter"],
          "cache_strategy_pattern": "repeat", "global_tokens": 4, "recent_window": 10,
          "max_cache_length": [0.25], "cache_bits": 4}
    pos, pos_ref = _run_both(models, kw)
    np.testing.assert_array_equal(pos[0], pos_ref[0])  # the recent_global layer


def test_generate_heavy_hitter_pyramid(models):
    """``cache_configs/heavy_hitter_pyramid.yaml``: per-layer budgets from
    the pyramid ramp (the lower layer larger) and a 400-step history."""
    kw = _kw("heavy_hitter", 8, cache_length_pattern="pyramid", history_window_size=400)
    pos, pos_ref = _run_both(models, kw)
    assert [p.shape[-1] for p in pos] == [p.shape[-1] for p in pos_ref]
    assert pos[0].shape[-1] > pos[1].shape[-1]
