"""The whole slice: the port's ``generate()`` against the JAX package's, on
weights handed over through the checkpoint key scheme
(``runtime/engine.py::params_from_flat``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.models import transformer as JT
from cold_compress_tpu.models.config import ModelConfig as JaxModelConfig
from cold_compress_tpu.quantization.weight_quant import quantize_params
from cold_compress_tpu.runtime.engine import _flatten
from cold_compress_tpu.runtime.engine import build_cache_specs as jax_build_specs
from cold_compress_tpu.runtime.generate import generate as jax_generate
from cold_compress_tpu.runtime.stats import get_cache_stats as jax_stats
from cold_compress_tpu.runtime.stats import unstack_caches

from cold_compress_tpu_torch.models import transformer as TT
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.ops import kernel_launches
from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model, params_from_flat
from cold_compress_tpu_torch.runtime.generate import generate, reset_caches
from cold_compress_tpu_torch.runtime.stats import get_cache_stats

HH_KW = {
    "cache_strategy": ["heavy_hitter"],
    "max_cache_length": [0.25],
    "prompt_compression_strategy": ["heavy_hitter"],
    "global_tokens": 4,
    "recent_window": 10,
}


def _port_model(name, jax_params, max_seq):
    cfg = ModelConfig.from_name(name)
    tree = params_from_flat(_flatten(jax_params), "cpu")
    return cfg, build_model(cfg, tree, "cpu", max_positions=max_seq)


def _port_caches(cfg, kw, max_seq, dtype):
    return TT.init_caches(cfg, build_cache_specs(cfg, kw, max_seq), 1, dtype, device="cpu")


def _jax_caches(cfg, kw, max_seq, dtype):
    return JT.init_caches(cfg, jax_build_specs(cfg, kw, max_seq), 1, dtype)


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxModelConfig.from_name("TestTiny")
    params = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return cfg, params


PROMPT_TINY = np.random.RandomState(5).randint(1, 500, size=90).tolist()


def test_f32_tiny_prefill_logits_and_greedy_tokens(tiny):
    """f32 dense TestTiny with a heavy-hitter cache at 25% of 128 (the
    90-token prompt is compressed, then decode evicts): prefill logits
    agree to f32 noise and 16 greedy tokens are identical."""
    jcfg, jparams = tiny
    cfg, model = _port_model("TestTiny", jparams, 128)
    rope = JT.make_rope_table(jcfg)

    tokens = PROMPT_TINY + [0] * (128 - len(PROMPT_TINY))
    jlogits, _ = JT.prefill(jcfg, jparams, rope, _jax_caches(jcfg, HH_KW, 128, jnp.float32),
                            jnp.asarray([tokens], jnp.int32), jnp.int32(len(PROMPT_TINY)))
    with torch.inference_mode():
        logits = TT.prefill(model, _port_caches(cfg, HH_KW, 128, torch.float32),
                            torch.tensor([tokens]), len(PROMPT_TINY))
    # f32 on both sides; the attention operands are rounded to bf16 on both
    # sides, so only summation order differs.
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)

    jseq, jinfo, _ = jax_generate(jcfg, jparams, rope,
                                  _jax_caches(jcfg, HH_KW, 128, jnp.float32), PROMPT_TINY, 16)
    caches = _port_caches(cfg, HH_KW, 128, torch.float32)
    seq, info, caches = generate(model, caches, PROMPT_TINY, 16)
    assert seq == jseq
    assert len(seq) == len(PROMPT_TINY) + 16
    np.testing.assert_allclose(info["emitted_probs"], jinfo["emitted_probs"], rtol=1e-3, atol=1e-5)
    assert info["perf_stats"]["decode_steps"] == 15
    assert int(caches[0].cache_ct.max()) == 32  # compressed to the budget

    # A fresh run over the reset caches repeats itself exactly.
    seq2, _, _ = generate(model, reset_caches(caches), PROMPT_TINY, 16)
    assert seq2 == seq


def _terminator_run(tiny, kw):
    """TestTiny, a 20-token prompt, 8 new tokens with the second greedy token
    declared a terminator, through both packages: (port seq, info, caches),
    (JAX seq, info, caches), and the sequence without the terminator."""
    jcfg, jparams = tiny
    cfg, model = _port_model("TestTiny", jparams, 128)
    prompt = PROMPT_TINY[:20]
    seq, _, _ = generate(model, _port_caches(cfg, kw, 128, torch.float32), prompt, 8)
    stop = seq[21]
    rope = JT.make_rope_table(jcfg)
    jax_out = jax_generate(jcfg, jparams, rope, _jax_caches(jcfg, kw, 128, jnp.float32),
                           prompt, 8, terminator_ids=[stop])
    port_out = generate(model, _port_caches(cfg, kw, 128, torch.float32), prompt, 8,
                        terminator_ids=[stop])
    return port_out, jax_out, seq


def _assert_caches_and_stats_match(caches, jcaches, prompt_len, gen_len):
    """Each layer's cache_ct, and every statistic ``get_cache_stats``
    reports, as the JAX package's."""
    for c, jc in zip(caches, unstack_caches(jcaches)):
        np.testing.assert_array_equal(c.cache_ct.numpy(), np.asarray(jc.cache_ct))
    stats = get_cache_stats(caches, prompt_len, gen_len)
    ref = jax_stats(jcaches, prompt_len, gen_len)
    assert list(stats) == list(ref)
    for key, val in ref.items():
        assert stats[key] == pytest.approx(val, rel=1e-4, abs=1e-6), key


def test_f32_tiny_full_cache_terminator(tiny):
    """Full cache, with the second greedy token declared a terminator: the
    port records nothing after it and stops where the JAX loop stops, so
    the caches hold the prompt and the one decoded token (21 rows) and the
    statistics agree."""
    kw = {"cache_strategy": ["full"], "max_cache_length": [1.0],
          "prompt_compression_strategy": ["full"]}
    (seq2, info2, caches), (jseq, jinfo, jcaches), seq = _terminator_run(tiny, kw)
    assert seq2 == jseq == seq[:22]
    assert info2["num_generated"] == jinfo["num_generated"] == 2
    np.testing.assert_allclose(info2["emitted_probs"], jinfo["emitted_probs"], rtol=1e-4)
    np.testing.assert_allclose(info2["final_probs"], jinfo["final_probs"], atol=1e-6)
    assert info2["perf_stats"]["decode_steps"] == 1
    assert int(caches[0].cache_ct.max()) == 21
    _assert_caches_and_stats_match(caches, jcaches, 20, 2)


def test_f32_tiny_debug_cache_terminator(tiny):
    """The same stop with a ``debug_heavy_hitter`` cache (a 16-slot shadow
    that compresses the prompt): the outer and shadow caches, the recorded
    attention losses and the statistics agree with the JAX package's."""
    kw = {"cache_strategy": ["debug_heavy_hitter"], "max_cache_length": [16],
          "prompt_compression_strategy": ["heavy_hitter"], "global_tokens": 2,
          "recent_window": 4}
    (seq2, info2, caches), (jseq, jinfo, jcaches), seq = _terminator_run(tiny, kw)
    assert seq2 == jseq == seq[:22]
    assert info2["perf_stats"]["decode_steps"] == 1
    for c, jc in zip(caches, unstack_caches(jcaches)):
        assert int(c.extra["attention_loss_ctr"]) == int(jc.extra["attention_loss_ctr"]) == 1
        np.testing.assert_allclose(c.extra["attention_losses"].numpy(),
                                   np.asarray(jc.extra["attention_losses"]), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_array_equal(c.extra["shadow"].cache_ct.numpy(),
                                      np.asarray(jc.extra["shadow"].cache_ct))
    _assert_caches_and_stats_match(caches, jcaches, 20, 2)


# ---------------------------------------------------------------------------
# TestKernel: int4 weights and head, kv8 heavy-hitter cache (the main path's
# options at the smallest shapes every kernel takes), teacher-forced.
# ---------------------------------------------------------------------------

PROMPT = np.random.RandomState(0).randint(2, 500, size=300).tolist()
FORCED = np.random.RandomState(1).randint(2, 500, size=8).tolist()
KV8_KW = dict(HH_KW, cache_bits=8)
JAX_GATES = ("CCT_PALLAS_INTERPRET", "CCT_FUSED_EVICT", "CCT_TILED_HEAD",
             "CCT_PREFILL_W4A8", "CCT_QMM_CPT", "CCT_QMM_INKQ", "CCT_ATTN_I8DOT",
             "CCT_ATTN_V2", "CCT_ATTN_V2_OS_MB")


@pytest.fixture(scope="module")
def kernel_params():
    cfg = JaxModelConfig.from_name("TestKernel")
    params = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    return cfg, quantize_params(params, mode="int4", group_size=128, output_mode="int4")


def _jax_run(cfg, qp, env, monkeypatch):
    """The JAX program as tests/test_gates_e2e.py runs it."""
    for k in JAX_GATES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jax.clear_caches()
    p = JT.fuse_layer_params(JT.stack_layer_params(qp))
    if env.get("CCT_PALLAS_INTERPRET") == "1":
        p = JT.colpack_layer_params(p)
        if env.get("CCT_TILED_HEAD") == "1":
            p = JT.tile_output_head(p)
    caches = _jax_caches(cfg, KV8_KW, 512, jnp.bfloat16)
    _, info, _ = jax_generate(cfg, p, JT.make_rope_table(cfg), caches, PROMPT, 8,
                              prefill_bucket=512, next_tokens=FORCED)
    for k in JAX_GATES:
        monkeypatch.delenv(k, raising=False)
    jax.clear_caches()
    return np.asarray(info["emitted_probs"]), np.asarray(info["final_probs"])


@pytest.fixture(scope="module")
def port_kernel_run(kernel_params, request):
    """The port's run, with decode attention's ``i8dot`` mode ``off`` (the
    dequantizing branch, as JAX's XLA path and ``CCT_ATTN_I8DOT=0``) unless
    a test asks for ``auto`` (the TPU program's default)."""
    _, qp = kernel_params
    cfg, model = _port_model("TestKernel", qp, 512)
    TT.set_attn_i8dot(model, {"off": False, "auto": "auto"}[getattr(request, "param", "off")])
    caches = _port_caches(cfg, KV8_KW, 512, torch.bfloat16)
    before = kernel_launches()
    seq, info, caches = generate(model, caches, PROMPT, 8, prefill_bucket=512,
                                 next_tokens=FORCED)
    assert kernel_launches() == before  # CPU tensors: plain versions only
    assert seq == PROMPT + FORCED
    assert caches[0].k.dtype == torch.uint8
    assert int(caches[0].cache_ct.max()) == 128
    return np.asarray(info["emitted_probs"]), np.asarray(info["final_probs"])


# Tolerances, relative: the probabilities of this random model are ~2e-3, so
# an absolute bound would say nothing. The prefill step's probability carries
# no eviction yet and agrees to 5e-3 (1e-2 against the XLA path, whose
# activations stay bf16). Later steps pass through int8 activation
# quantization, where bf16 summation-order noise upstream flips single int8
# units and moves a probability by up to ~1.5% (the JAX package's own
# interpret and XLA paths differ by 1.0% here). The last step also follows a
# heavy-hitter near-tie: in layer 1 two slots' histories are within 2e-4
# relative of each other and the port keeps the other one, which moves
# final_probs by up to 4% (0.04 in log-probability).
LOGP_TOL = 8e-2
# The port's i8dot branch against the TPU program's (both i8dot): measured
# 9.67e-3 relative on the steps and 0.0633 on the final log-probabilities
# (the matched dequantizing pair: 7.9e-3 and 0.0231). Decode attention
# agrees closely (tests/test_torch_i8dot.py); the final step's gap is the
# heavy-hitter near-tie above, which the other branch resolves the other
# way. The bounds are at or below the dequantizing pair's 3e-2 and 8e-2.
AUTO_STEPS_RTOL = 2e-2
AUTO_LOGP_TOL = LOGP_TOL


def _check_probs(e, f, e_ref, f_ref, first_rtol, steps_rtol, logp_tol=LOGP_TOL):
    np.testing.assert_allclose(e[0], e_ref[0], rtol=first_rtol)
    np.testing.assert_allclose(e, e_ref, rtol=steps_rtol)
    assert np.all(f > 0) and abs(float(f.sum()) - 1.0) < 1e-3
    assert float(np.abs(np.log(f) - np.log(f_ref)).max()) <= logp_tol


@pytest.mark.parametrize("port_kernel_run,i8dot,steps_rtol,logp_tol", [
    pytest.param("off", "0", 3e-2, LOGP_TOL, id="0-0.03-0.08"),
    pytest.param("off", "1", 2e-2, 6.8e-2, id="1-0.02-0.068"),
    pytest.param("auto", "1", AUTO_STEPS_RTOL, AUTO_LOGP_TOL, id="auto-1"),
], indirect=["port_kernel_run"])
def test_int4_kv8_matches_tpu_program_in_interpret_mode(kernel_params, port_kernel_run,
                                                        monkeypatch, i8dot, steps_rtol,
                                                        logp_tol):
    """Against the TPU program (Pallas kernels in interpret mode, tiled int4
    head): both quantize activations to int8 and the cache to uint8, and
    round at the same places but for K4's P.V (normalised vs unnormalised
    probabilities to bf16) and the cpt sidecar's bf16 zero term.

    Like against like: the port's dequantizing decode attention against
    ``CCT_ATTN_I8DOT=0`` (``[0-...]``), per-step probabilities within 3%
    relative, final log-probabilities within ``LOGP_TOL``; the port's
    ``auto`` (its i8dot branch here, C = 128) against ``CCT_ATTN_I8DOT=1``,
    the JAX package's default for kv8 caches (``[auto-1]``), within
    ``AUTO_STEPS_RTOL`` and ``AUTO_LOGP_TOL``. Across branches (``[1-...]``:
    the port's dequantizing branch against i8dot): measured 1.16e-2 relative
    on the steps and 0.0343 on the final log-probabilities; the bounds, 2e-2
    and 6.8e-2, are under twice those."""
    cfg, qp = kernel_params
    e_ref, f_ref = _jax_run(cfg, qp, {"CCT_PALLAS_INTERPRET": "1", "CCT_TILED_HEAD": "1",
                                      "CCT_ATTN_I8DOT": i8dot}, monkeypatch)
    e, f = port_kernel_run
    _check_probs(e, f, e_ref, f_ref, first_rtol=5e-3, steps_rtol=steps_rtol, logp_tol=logp_tol)


def test_int4_kv8_matches_jax_xla_path(kernel_params, port_kernel_run, monkeypatch):
    """Against JAX's plain XLA path (bf16 activations into dequantized
    weights, dequantized K/V in decode attention, as the port's run with
    i8dot off): the 5e-2 of tests/test_gates_e2e.py, taken relative."""
    cfg, qp = kernel_params
    e_ref, f_ref = _jax_run(cfg, qp, {}, monkeypatch)
    e, f = port_kernel_run
    _check_probs(e, f, e_ref, f_ref, first_rtol=1e-2, steps_rtol=5e-2)


# ---------------------------------------------------------------------------
# Long prompts fed through decode, and the last prompt token decoded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("feed,first", [(True, False), (False, True), (True, True)])
def test_feed_long_prompts_and_decode_first_token_match_jax(tiny, feed, first):
    """f32 TestTiny with a 32-slot heavy-hitter cache and the 90-token
    prompt: ``feed_long_prompts`` prefills 31 tokens and forces the other 59
    through decode, ``decode_first_token`` forces the last prompt token;
    the same sequence and probabilities as the JAX package's ``generate()``,
    and every fed step counts as a decode step."""
    jcfg, jparams = tiny
    cfg, model = _port_model("TestTiny", jparams, 128)
    rope = JT.make_rope_table(jcfg)
    kw = dict(feed_long_prompts=feed, decode_first_token=first)
    jseq, jinfo, _ = jax_generate(jcfg, jparams, rope, _jax_caches(jcfg, HH_KW, 128, jnp.float32),
                                  PROMPT_TINY, 8, **kw)
    seq, info, caches = generate(model, _port_caches(cfg, HH_KW, 128, torch.float32),
                                 PROMPT_TINY, 8, **kw)
    assert seq == jseq and seq[:len(PROMPT_TINY)] == PROMPT_TINY
    assert info["prompt_length"] == jinfo["prompt_length"] == (31 if feed else 89) - (
        1 if feed and first else 0)
    fed = len(PROMPT_TINY) - info["prompt_length"]
    assert info["perf_stats"]["decode_steps"] == fed + 8 - 1
    np.testing.assert_allclose(info["emitted_probs"], jinfo["emitted_probs"], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(info["final_probs"], jinfo["final_probs"], rtol=1e-3, atol=1e-6)


def test_min_cache_length_and_pad_id_follow_jax(tiny):
    """An explicit ``min_cache_length`` (below the caches') decides how much
    of the prompt is fed; ``pad_id`` pads the prefill bucket (the padded
    slots stay masked, so the tokens do not move)."""
    jcfg, jparams = tiny
    cfg, model = _port_model("TestTiny", jparams, 128)
    rope = JT.make_rope_table(jcfg)
    kw = dict(feed_long_prompts=True, min_cache_length=24, pad_id=7)
    jseq, jinfo, _ = jax_generate(jcfg, jparams, rope, _jax_caches(jcfg, HH_KW, 128, jnp.float32),
                                  PROMPT_TINY, 6, **kw)
    seq, info, _ = generate(model, _port_caches(cfg, HH_KW, 128, torch.float32), PROMPT_TINY, 6,
                            **kw)
    assert info["prompt_length"] == jinfo["prompt_length"] == 23
    assert seq == jseq
    np.testing.assert_allclose(info["emitted_probs"], jinfo["emitted_probs"], rtol=1e-3,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# int8 and bf16 layer weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_kernel_params():
    cfg = JaxModelConfig.from_name("TestKernel")
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)


def _port_forced_run(qp):
    """The port with decode attention's dequantizing branch, as its JAX
    counterparts (``CCT_ATTN_I8DOT=0``, the XLA path) compute it."""
    cfg, model = _port_model("TestKernel", qp, 512)
    TT.set_attn_i8dot(model, False)
    before = kernel_launches()
    seq, info, _ = generate(model, _port_caches(cfg, KV8_KW, 512, torch.bfloat16), PROMPT, 8,
                            prefill_bucket=512, next_tokens=FORCED)
    assert kernel_launches() == before and seq == PROMPT + FORCED
    return model, np.asarray(info["emitted_probs"]), np.asarray(info["final_probs"])


def test_int8_layers_kv8_match_tpu_program_in_interpret_mode(bf16_kernel_params, monkeypatch):
    """int8 layers and head (``quantize_params(mode="int8")``, as the
    quantize CLI writes them) against the TPU program in interpret mode:
    its layers take XLA's ``w8a8_matmul``, its head the tiled W8A8 kernel;
    the port's all take K9's plain version. Tolerances as the int4 run's."""
    from cold_compress_tpu_torch.ops.linear import Int8Linear

    cfg, params = bf16_kernel_params
    qp = quantize_params(params, mode="int8", output_mode="int8")
    model, e, f = _port_forced_run(qp)
    assert isinstance(model.layers[0].attention.wqkv, Int8Linear)
    e_ref, f_ref = _jax_run(cfg, qp, {"CCT_PALLAS_INTERPRET": "1", "CCT_TILED_HEAD": "1",
                                      "CCT_ATTN_I8DOT": "0"}, monkeypatch)
    _check_probs(e, f, e_ref, f_ref, first_rtol=5e-3, steps_rtol=3e-2)


def test_bf16_layers_kv8_match_jax_xla_path(bf16_kernel_params, monkeypatch):
    """Dense bf16 layers and head (``init_params``, the CLI's
    ``--random_weights``), fused q|k|v and w1|w3, through ``torch.matmul``
    against JAX's XLA dots."""
    from cold_compress_tpu_torch.ops.linear import DenseLinear

    cfg, params = bf16_kernel_params
    model, e, f = _port_forced_run(params)
    assert isinstance(model.layers[0].attention.wqkv, DenseLinear)
    assert model.layers[0].attention.wqkv.weight.shape == (cfg.dim, 512)
    e_ref, f_ref = _jax_run(cfg, params, {}, monkeypatch)
    _check_probs(e, f, e_ref, f_ref, first_rtol=1e-2, steps_rtol=5e-2)


# ---------------------------------------------------------------------------
# The decode loop's device-side step (decode_loop_core)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kernel_f32():
    jcfg = JaxModelConfig.from_name("TestKernel")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jparams




@pytest.mark.parametrize("name", ["TestTiny", "TestKernel"])
def test_mixed_prefix_with_terminators_matches_jax(tiny, kernel_f32, name):
    """``feed_long_prompts`` forces the prompt's tail through decode, then
    greedy steps follow until a terminator: one terminator occurs among the
    forced tokens (a forced step never stops the loop) and the other is the
    third greedy token. Tokens, decode steps, emitted and final
    probabilities as the JAX package's (f32 weights; probabilities within
    1e-3 relative, the bf16 roundings of the port's decode attention)."""
    # A heavy-hitter cache at a quarter of max_seq: the prompt's tail past
    # its length less one is fed through decode.
    (jcfg, jparams), prompt, max_seq = ((tiny, PROMPT_TINY, 128) if name == "TestTiny"
                                        else (kernel_f32, PROMPT[:140], 512))
    cfg, model = _port_model(name, jparams, max_seq)
    rope = JT.make_rope_table(jcfg)
    kw = HH_KW
    fed = prompt[max_seq // 4 - 1:]
    free, _, _ = generate(model, _port_caches(cfg, kw, max_seq, torch.float32), prompt, 8,
                          feed_long_prompts=True)
    greedy = free[len(prompt):]
    terminators = [fed[len(fed) // 2], greedy[3]]
    args = dict(feed_long_prompts=True, terminator_ids=terminators)
    jseq, jinfo, _ = jax_generate(jcfg, jparams, rope, _jax_caches(jcfg, kw, max_seq,
                                                                   jnp.float32), prompt, 8,
                                  **args)
    seq, info, _ = generate(model, _port_caches(cfg, kw, max_seq, torch.float32), prompt, 8,
                            **args)
    assert seq == jseq and seq[:len(prompt)] == prompt
    steps = info["perf_stats"]["decode_steps"]
    assert steps == len(seq) - info["prompt_length"] - 1
    assert len(fed) <= steps < len(fed) + 7  # past the forced tokens, stopped early
    assert seq[-1] in terminators
    np.testing.assert_allclose(info["emitted_probs"], jinfo["emitted_probs"], rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(info["final_probs"], jinfo["final_probs"], rtol=1e-3, atol=1e-6)


#: Strategies whose decode step reads the position (eviction scores, the
#: recent window, the counter-based draws, hybrid's windows, the shadow).
POSITION_CASES = {
    "full": ("full", None), "heavy_hitter": ("heavy_hitter", 8), "hybrid": ("hybrid", 8),
    "random": ("random", 8), "l2_kv4": ("l2", 4), "debug_heavy_hitter": ("debug_heavy_hitter", 8),
}


@pytest.mark.parametrize("case", list(POSITION_CASES))
def test_decode_step_at_a_tensor_position_is_bit_equal(case):
    """``decode_step`` at an int position, at a 0-d tensor and at a [B]
    tensor (what the decode loop passes: a captured step reads its position
    from the device): three steps from the same prefilled caches give the
    same logits and leave every cache tensor the same, bit for bit
    (TestKernel, random int4 weights, on the CPU)."""
    import copy

    from cold_compress_tpu_torch.bench import cache_kwargs
    from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params

    strategy, bits = POSITION_CASES[case]
    cfg = ModelConfig.from_name("TestKernel")
    model = build_model(cfg, params_from_flat(random_quantized_params(cfg, seed=0), "cpu"),
                        "cpu", max_positions=512)
    kw = cache_kwargs(strategy, 0.25, 4, bits)
    caches = _port_caches(cfg, kw, 512, torch.bfloat16)
    P = 300
    with torch.inference_mode():
        TT.prefill(model, caches, torch.tensor([PROMPT + [0] * (512 - P)]), P)
    states = {kind: copy.deepcopy(caches) for kind in ("int", "0-d", "[B]")}
    tokens = [FORCED[0], FORCED[1], 20]  # 20: one of bench's punctuation ids
    out = {}
    for kind, st in states.items():
        logits = []
        for step, tok in enumerate(tokens):
            pos = {"int": P + step, "0-d": torch.tensor(P + step, dtype=torch.int32),
                   "[B]": torch.tensor([P + step], dtype=torch.int32)}[kind]
            with torch.inference_mode():
                logits.append(TT.decode_step(model, st, torch.tensor([tok]), pos))
        out[kind] = torch.stack(logits)
    for kind in ("0-d", "[B]"):
        assert torch.equal(out[kind], out["int"]), kind
        for c, ref in zip(states[kind], states["int"]):
            assert all(torch.equal(a, b) for a, b in zip(c.tensors(), ref.tensors())), kind


def test_cuda_graph_needs_the_card():
    """``cuda_graph=True`` on a model on the CPU raises; it never decodes
    eagerly in its place."""
    cfg = ModelConfig.from_name("TestTiny")
    model = build_model(cfg, TT.init_params(cfg, device="cpu"), "cpu", max_positions=128)
    with pytest.raises(ValueError, match="cuda_graph"):
        generate(model, _port_caches(cfg, HH_KW, 128, torch.bfloat16), PROMPT_TINY[:20], 4,
                 cuda_graph=True)
