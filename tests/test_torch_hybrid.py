"""The port's FastGen hybrid cache against the JAX package's: token
classes, the policy menu, the profile accumulators and their scores, the
reordered prefill fill, the vectorised decode step (byte-identical at kv8,
dropping and punctuation-tracking heads included) and ``generate`` end to
end.

The JAX states are functional; the port's are updated in place, so each
step compares the port's state with the JAX result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.caches import base as JB
from cold_compress_tpu.caches import hybrid as JH
from cold_compress_tpu.models import transformer as JT
from cold_compress_tpu.models.config import ModelConfig as JaxModelConfig
from cold_compress_tpu.runtime.engine import _flatten
from cold_compress_tpu.runtime.engine import build_cache_specs as jax_build_specs
from cold_compress_tpu.runtime.generate import generate as jax_generate
from cold_compress_tpu.runtime.stats import unstack_caches

from cold_compress_tpu_torch.caches import base as TB
from cold_compress_tpu_torch.caches import get_cache_strategy
from cold_compress_tpu_torch.caches import hybrid as TH
from cold_compress_tpu_torch.models import transformer as TT
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.ops import kernel_launches
from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model, params_from_flat
from cold_compress_tpu_torch.runtime.generate import generate

MENU = [
    {"strategy": "special"},
    {"strategy": "special_punc"},
    {"strategy": "window", "recent_window": 0.1},
    {"strategy": "window_heavy_hitter", "recent_window": 0.3, "heavy_hitter_frac": 0.25},
    {"strategy": "special_punc_heavy_hitter", "heavy_hitter_frac": 0.3},
    {"strategy": "full"},
]
SPECIAL = ((5,), (7, 8, 9))
PUNC = (46, 44, 33)


def _t(a):
    return torch.from_numpy(np.array(a))


def _specs(P, bits=None, min_recovery=0.9, global_tokens=3):
    kw = dict(cache_strategy="hybrid", max_cache_length=P, max_seq_length=P,
              global_tokens=global_tokens, cache_bits=bits, min_recovery_frac=min_recovery,
              token_ids_special=SPECIAL, token_ids_punc=PUNC)
    return (JB.CacheSpec(hybrid_strategies=JH.normalize_hybrid_strategies(MENU), **kw),
            TB.CacheSpec(hybrid_strategies=TH.normalize_hybrid_strategies(MENU), **kw))


def _tokens(rng, B, P):
    """Ids from a small vocabulary, so special ids, the 7-8-9 sequence and
    punctuation all occur."""
    toks = rng.choice([1, 2, 3, 5, 7, 8, 9, 33, 44, 46, 11, 12, 13, 14], size=(B, P))
    toks[:, 10:13] = [7, 8, 9]
    return toks.astype(np.int32)


def test_special_and_punctuation_masks_match_jax():
    """Single ids and exact multi-token subsequences (a partial 7-8 is not
    special), and punctuation ids."""
    jspec, tspec = _specs(16)
    toks = np.asarray([[1, 5, 2, 7, 8, 9, 7, 8, 3, 46, 44, 7, 8, 9, 33, 9]], np.int32)
    want = np.asarray(JH._special_token_mask(jspec, jnp.asarray(toks)))
    got = TH._special_token_mask(tspec, _t(toks).long()).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist()[:9] == [False, True, False, True, True, True, False, False, False]
    np.testing.assert_array_equal(TH._punc_token_mask(tspec, _t(toks).long()).numpy(),
                                  np.asarray(JH._punc_token_mask(jspec, jnp.asarray(toks))))


def test_menu_tables_match_jax():
    jspec, tspec = _specs(100)
    want = JH._menu_tables(jspec)
    got = TH._menu_tables(tspec)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(val), err_msg=key)
    assert got["window_len"].tolist() == [0, 0, 10, 30, 0, 0]
    assert got["hh_budget"].tolist() == [0, 0, 0, 25, 30, 0]


B, KVH, G, P, D = 2, 2, 2, 96, 16
PLENS = [70, 61]


def _profile_inputs(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, KVH * G, P, D).astype(np.float32)
    k = rng.randn(B, KVH, P, D).astype(np.float32)
    v = rng.randn(B, KVH, P, D).astype(np.float32)
    valid = np.arange(P)[None, :] < np.asarray(PLENS)[:, None]
    return rng, q, k, v, valid


def test_profile_partial_and_finalize_match_jax():
    """The streamed accumulators (chunk 40, so the last chunk is ragged)
    agree to f32 summation noise; fed the same accumulators, the per-key
    means and every menu entry's recovered share agree to f32 noise."""
    rng, q, k, _, valid = _profile_inputs(0)
    jspec, tspec = _specs(P)
    plens = np.asarray(PLENS, np.int32)
    cum_j, w_j = JH._profile_partial(jspec, jnp.asarray(q), jnp.asarray(k), jnp.asarray(plens),
                                     chunk_size=40)
    cum_t, w_t = TH._profile_partial(tspec, _t(q), _t(k), _t(plens), chunk_size=40)
    assert w_t.shape == (2, B, KVH, P)  # distinct windows 9 and 28
    scale = float(np.abs(np.asarray(cum_j)).max())
    np.testing.assert_allclose(cum_t.numpy(), np.asarray(cum_j), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0, atol=1e-5 * scale)

    toks = _tokens(rng, B, P)
    special = JH._special_token_mask(jspec, jnp.asarray(toks)) & valid
    punc = JH._punc_token_mask(jspec, jnp.asarray(toks)) & valid
    ca_j, sc_j = JH._profile_finalize(jspec, cum_j, w_j, jnp.asarray(valid), jnp.asarray(plens),
                                      special, punc)
    ca_t, sc_t = TH._profile_finalize(tspec, _t(cum_j), _t(w_j), _t(valid), _t(plens),
                                      _t(special), _t(punc))
    np.testing.assert_allclose(ca_t.numpy(), np.asarray(ca_j), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=1e-5, atol=1e-6)
    assert sc_t.shape == (len(MENU), B, KVH)
    np.testing.assert_allclose(sc_t[-1].numpy(), 1.0, rtol=1e-5)  # "full" keeps it all


def _state_pair(jspec, tspec, strat_t):
    js = JH.HybridCache.init(jspec, B, KVH, D, jnp.float32)
    ts = strat_t.init(tspec, B, KVH, D, torch.float32, device="cpu")
    return js, ts


def _same_hybrid_state(ts, js, quantized):
    for f in ("pos", "mask", "cache_ct"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    for f in ("k", "v") + (("k_scales", "k_zeros", "v_scales", "v_zeros") if quantized else ()):
        assert getattr(ts, f).numpy().tobytes() == np.asarray(getattr(js, f)).tobytes(), f
    for key in ("strategy_idx", "special_mask", "punc_mask", "num_special", "num_punc",
                "attn_denom", "attn_counter"):
        np.testing.assert_array_equal(ts.extra[key].numpy(), np.asarray(js.extra[key]),
                                      err_msg=key)
    np.testing.assert_allclose(ts.extra["attn_num"].numpy(), np.asarray(js.extra["attn_num"]),
                               rtol=1e-6, atol=1e-9)


# At 0.3 this fixture's heads take the two non-evicting entries (special,
# special_punc), which drop tokens past their budget; at 0.5 the two
# windowed ones, which evict.
@pytest.mark.parametrize("min_recovery,branch", [(0.3, "drop"), (0.5, "evict")])
def test_fill_after_profile_and_decode_steps_match_jax(min_recovery, branch):
    """kv8 cache. The fill (same accumulators on both sides): identical
    policies, kept positions, masks, counts, token-class masks and quantized
    bytes, the seeded history to f32 noise. Then 24 decode steps with
    punctuation tokens and attention observations: every step inserts,
    evicts or drops into the same slots and leaves the same bytes (a
    dropping head's slot C - 1 byte-identical)."""
    rng, q, k, v, valid = _profile_inputs(1)
    jspec, tspec = _specs(P, bits=8, min_recovery=min_recovery)
    strat = get_cache_strategy("hybrid")
    js, ts = _state_pair(jspec, tspec, strat)
    plens = np.asarray(PLENS, np.int32)
    toks = _tokens(rng, B, P)
    cum, wcols = JH._profile_partial(jspec, jnp.asarray(q), jnp.asarray(k), jnp.asarray(plens))
    ipos = np.arange(P, dtype=np.int32)
    js = JH.HybridCache.fill_after_profile(
        jspec, js, cum, wcols, jnp.asarray(k), jnp.asarray(v), jnp.asarray(toks),
        jnp.asarray(ipos), jnp.asarray(valid), jnp.asarray(plens))
    strat.fill_after_profile(tspec, ts, _t(cum), _t(wcols), _t(k), _t(v), _t(toks).long(),
                             _t(ipos), _t(valid), _t(plens))
    _same_hybrid_state(ts, js, quantized=True)
    policies = set(ts.extra["strategy_idx"].flatten().tolist())
    assert len(policies) >= 2, policies

    evicted = dropped = 0
    for step in range(24):
        pos = int(max(PLENS)) + step
        kr = rng.randn(B, KVH, 1, D).astype(np.float32)
        vr = rng.randn(B, KVH, 1, D).astype(np.float32)
        tok = np.asarray([PUNC[step % 3] if step % 4 == 1 else 11 + step % 3, 46], np.int32)
        before_ct = ts.cache_ct.clone()
        js, *_ = JH.HybridCache.decode_update(js, jnp.int32(pos), jnp.asarray(kr),
                                              jnp.asarray(vr), token=jnp.asarray(tok))
        TB.decode_update(strat, ts, pos, _t(kr), _t(vr), token=_t(tok).long())
        attn = rng.dirichlet(np.ones(P), size=(B, KVH)).astype(np.float32)
        attn = attn * np.asarray(js.mask)
        js = JH.HybridCache.update_state(jspec, js, pos, jnp.asarray(attn), is_prefill=False)
        strat.update_state(tspec, ts, pos, _t(attn), is_prefill=False)
        _same_hybrid_state(ts, js, quantized=True)
        inserted = (ts.pos == pos).any(-1)
        evicted += int(((ts.cache_ct == before_ct) & inserted).sum())
        dropped += int((~inserted).sum())
    assert (evicted if branch == "evict" else dropped) > 0


def test_dummy_slot_drop_quantized_byte_identity_matches_jax():
    """A punctuation-only head over its budget at exact occupancy drops the
    token into slot C - 1, which holds a real row: every buffer of that head
    stays byte-identical, while a ``full`` head appends into the clamped
    last slot; the JAX package's own regression case, on both sides."""
    C, H2, D2 = 8, 2, 4
    menu = [{"strategy": "special_punc"}, {"strategy": "full"}]
    kw = dict(cache_strategy="hybrid", max_cache_length=C, max_seq_length=64, global_tokens=2,
              cache_bits=8, token_ids_special=((9,),), token_ids_punc=(46,))
    jspec = JB.CacheSpec(hybrid_strategies=JH.normalize_hybrid_strategies(menu), **kw)
    tspec = TB.CacheSpec(hybrid_strategies=TH.normalize_hybrid_strategies(menu), **kw)
    rng = np.random.RandomState(0)
    fields = dict(
        k=rng.randint(0, 256, (1, H2, C, D2)).astype(np.uint8),
        v=rng.randint(0, 256, (1, H2, C, D2)).astype(np.uint8),
        k_scales=rng.rand(1, H2, C).astype(np.float32),
        k_zeros=rng.rand(1, H2, C).astype(np.float32),
        v_scales=rng.rand(1, H2, C).astype(np.float32),
        v_zeros=rng.rand(1, H2, C).astype(np.float32),
        pos=np.broadcast_to(np.arange(C, dtype=np.int32), (1, H2, C)).copy(),
        mask=np.ones((1, H2, C), bool),
        cache_ct=np.full((1, H2), C, np.int32),
    )
    punc_mask = np.zeros((1, H2, C), bool)
    punc_mask[0, 0, 2:4] = True
    js = JH.HybridCache.init(jspec, 1, H2, D2, jnp.float32)
    extra = dict(js.extra, strategy_idx=jnp.asarray([[0, 1]], jnp.int32),
                 punc_mask=jnp.asarray(punc_mask), num_punc=jnp.asarray([2], jnp.int32))
    js = js.replace(extra=extra, **{f: jnp.asarray(a) for f, a in fields.items()})
    ts = get_cache_strategy("hybrid").init(tspec, 1, H2, D2, torch.float32, device="cpu")
    for f, a in fields.items():
        getattr(ts, f).copy_(_t(a))
    ts.extra["strategy_idx"].copy_(torch.tensor([[0, 1]]))
    ts.extra["punc_mask"].copy_(_t(punc_mask))
    ts.extra["num_punc"].fill_(2)
    row = np.full((1, H2, 1, D2), 0.37, np.float32)
    js, *_ = JH.HybridCache.decode_update(js, jnp.int32(C), jnp.asarray(row), jnp.asarray(row),
                                          token=jnp.asarray([5], jnp.int32))
    TB.decode_update(get_cache_strategy("hybrid"), ts, C, _t(row), _t(row),
                     token=torch.tensor([5]))
    for f in fields:
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert got.tobytes() == want.tobytes(), f
        np.testing.assert_array_equal(got[0, 0], fields[f][0, 0], err_msg=f)
    assert ts.k[0, 1, C - 1].tolist() != fields["k"][0, 1, C - 1].tolist()
    assert int(ts.pos[0, 1, C - 1]) == C and ts.cache_ct.tolist() == [[C, C]]


def test_strategy_histogram_and_needs_attn():
    _, tspec = _specs(P)
    strat = get_cache_strategy("hybrid")
    st = strat.init(tspec, B, KVH, D, device="cpu")
    st.extra["strategy_idx"].copy_(torch.tensor([[0, 3], [3, 5]]))
    hist = strat.strategy_histogram(tspec, st)
    np.testing.assert_allclose(hist.numpy(), [0.25, 0, 0, 0.5, 0, 0.25])
    assert TB.strategy_needs_attn(strat, tspec)
    no_hh = TB.CacheSpec(cache_strategy="hybrid", hybrid_strategies=TH.normalize_hybrid_strategies(
        [{"strategy": "special_punc"}, {"strategy": "full"}]))
    assert not TB.strategy_needs_attn(strat, no_hh)


# ---------------------------------------------------------------------------
# generate() end to end
# ---------------------------------------------------------------------------

HYBRID_KW = {
    "cache_strategy": ["hybrid"], "max_cache_length": [1.0],
    "prompt_compression_strategy": ["full"], "global_tokens": 2,
    "hybrid_strategies": [
        {"strategy": "window", "recent_window": 0.1},
        {"strategy": "special_punc_heavy_hitter", "heavy_hitter_frac": 0.25},
        {"strategy": "window_heavy_hitter", "heavy_hitter_frac": 0.5, "recent_window": 0.1},
        {"strategy": "full"},
    ],
}
TINY_TOKEN_IDS = {"special": [[256], [257]], "punctuation": [46, 44, 33]}


def _policies_and_pos(caches):
    return ([c.extra["strategy_idx"].numpy() for c in caches],
            [c.pos.numpy() for c in caches])


def _jax_policies_and_pos(caches):
    caches = unstack_caches(caches)
    return ([np.asarray(c.extra["strategy_idx"]) for c in caches],
            [np.asarray(c.pos) for c in caches])


@pytest.mark.parametrize("min_recovery", [0.3, 0.85])
def test_generate_tiny_matches_jax(tiny_model, min_recovery):
    """TestTiny in f32 (head_dim 16: the chunked attention and the plain
    profile on both sides), greedy: the same policies per head, the same
    kept positions and the same 16 tokens; probabilities to f32 noise."""
    jcfg, jparams, rope = tiny_model
    kw = dict(HYBRID_KW, min_recovery_frac=min_recovery)
    prompt = [256] + list(range(1, 60)) + [46, 7, 257, 9, 44, 33, 12]
    jcaches = JT.init_caches(jcfg, jax_build_specs(jcfg, kw, 96, token_ids=TINY_TOKEN_IDS), 1,
                             jnp.float32)
    jseq, jinfo, jcaches = jax_generate(jcfg, jparams, rope, jcaches, prompt, 16)
    cfg = ModelConfig.from_name("TestTiny")
    model = build_model(cfg, params_from_flat(_flatten(jparams), "cpu"), "cpu", max_positions=96)
    caches = TT.init_caches(cfg, build_cache_specs(cfg, kw, 96, token_ids=TINY_TOKEN_IDS), 1,
                            torch.float32, device="cpu")
    seq, info, caches = generate(model, caches, prompt, 16)
    assert seq == jseq
    np.testing.assert_allclose(info["emitted_probs"], jinfo["emitted_probs"], rtol=1e-3)
    (pol, pos), (jpol, jpos) = _policies_and_pos(caches), _jax_policies_and_pos(jcaches)
    for layer in range(cfg.n_layer):
        np.testing.assert_array_equal(pol[layer], jpol[layer], err_msg=f"layer {layer}")
        np.testing.assert_array_equal(pos[layer], jpos[layer], err_msg=f"layer {layer}")


KERNEL_PROMPT = np.random.RandomState(0).choice(
    [1, 2, 16, 17, 20, 33, 47] + list(range(100, 400)), size=300).tolist()
KERNEL_FORCED = np.random.RandomState(1).randint(2, 500, size=12).tolist()


def test_generate_test_kernel_kv8_matches_jax():
    """TestKernel (head_dim 128: the port takes K6's plain version), f32
    weights, bench.py's FastGen menu and token classes over a kv8 cache,
    teacher-forced: the same policies and kept positions in every layer;
    emitted and final probabilities within 3% relative (the port rounds
    decode attention's operands to bf16 as the TPU kernel does, JAX's XLA
    path on the CPU keeps f32)."""
    from cold_compress_tpu_torch.bench import cache_kwargs

    jcfg = JaxModelConfig.from_name("TestKernel")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    kw = dict(cache_kwargs("hybrid", 0.25, 4, 8), min_recovery_frac=0.5)
    jcaches = JT.init_caches(jcfg, jax_build_specs(jcfg, kw, 512), 1, jnp.float32)
    _, jinfo, jcaches = jax_generate(jcfg, jparams, JT.make_rope_table(jcfg), jcaches,
                                     KERNEL_PROMPT, len(KERNEL_FORCED), prefill_bucket=512,
                                     next_tokens=KERNEL_FORCED)
    cfg = ModelConfig.from_name("TestKernel")
    # Dequantized K/V in decode attention, as JAX's XLA path.
    model = build_model(cfg, params_from_flat(_flatten(jparams), "cpu"), "cpu", max_positions=512,
                        attn_i8dot=False)
    caches = TT.init_caches(cfg, build_cache_specs(cfg, kw, 512), 1, torch.float32, device="cpu")
    before = kernel_launches()
    seq, info, caches = generate(model, caches, KERNEL_PROMPT, len(KERNEL_FORCED),
                                 prefill_bucket=512, next_tokens=KERNEL_FORCED)
    assert kernel_launches() == before  # CPU tensors: plain versions only
    assert seq == KERNEL_PROMPT + KERNEL_FORCED
    np.testing.assert_allclose(info["emitted_probs"], jinfo["emitted_probs"], rtol=3e-2)
    np.testing.assert_allclose(info["final_probs"], jinfo["final_probs"], rtol=3e-2, atol=1e-6)
    (pol, pos), (jpol, jpos) = _policies_and_pos(caches), _jax_policies_and_pos(jcaches)
    for layer in range(cfg.n_layer):
        np.testing.assert_array_equal(pol[layer], jpol[layer], err_msg=f"layer {layer}")
        np.testing.assert_array_equal(pos[layer], jpos[layer], err_msg=f"layer {layer}")
