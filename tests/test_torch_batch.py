"""Batched generation: the port's ``generate_batch`` against the JAX
package's, on weights handed over through the checkpoint key scheme
(``runtime/engine.py::params_from_flat``).

f32 TestTiny, three prompts of 20, 33 and 40 tokens in one prefill bucket
of 64 slots, 8 greedy tokens per lane: the same sequences token for token,
emitted probabilities within 1e-5 and the same ``perf_stats`` keys, for
every cache strategy. Then the three cases of ``tests/test_batch.py`` on
the port, a lane whose prompt fills the smallest cache, and TestKernel with
int4 weights over a kv8 heavy-hitter cache at two lanes, teacher-forced,
against the TPU program in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.caches import CacheSpec as JaxCacheSpec
from cold_compress_tpu.caches import hybrid as JH
from cold_compress_tpu.models import transformer as JT
from cold_compress_tpu.models.config import ModelConfig as JaxModelConfig
from cold_compress_tpu.quantization.weight_quant import quantize_params
from cold_compress_tpu.runtime.engine import _flatten
from cold_compress_tpu.runtime.generate import generate_batch as jax_generate_batch

from cold_compress_tpu_torch.caches import CacheSpec
from cold_compress_tpu_torch.caches import hybrid as TH
from cold_compress_tpu_torch.models import transformer as TT
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.ops import kernel_launches
from cold_compress_tpu_torch.runtime.engine import build_model, params_from_flat
from cold_compress_tpu_torch.runtime.generate import generate, generate_batch, reset_caches
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MAX_SEQ = 64
PROMPTS = [
    list(range(5, 25)),   # 20 tokens
    list(range(40, 73)),  # 33 tokens
    list(range(7, 47)),   # 40 tokens
]
#: tests/test_torch_hybrid.py's menu and token classes.
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

#: name: (strategy, cache length, prompt compressor, more spec fields). The
#: debug cache's 44 slots cap the bucket at 44 (its outer cache fills
#: directly) and its heavy-hitter shadow evicts in the 40-token lane.
CASES = {
    "full": ("full", MAX_SEQ, "recent_global", {}),
    "recent_global": ("recent_global", 24, "recent_global", {}),
    "l2": ("l2", 24, "l2", {}),
    "heavy_hitter": ("heavy_hitter", 24, "heavy_hitter", {}),
    "hybrid-0.3": ("hybrid", MAX_SEQ, "full", {"min_recovery_frac": 0.3}),
    "hybrid-0.9": ("hybrid", MAX_SEQ, "full", {"min_recovery_frac": 0.9}),
    "debug_heavy_hitter": ("debug_heavy_hitter", 44, "heavy_hitter", {}),
}


def _specs(cfg, case, bits=None):
    strategy, C, pcs, extra = CASES[case]
    kw = dict(cache_strategy=strategy, max_cache_length=C, max_seq_length=MAX_SEQ,
              global_tokens=2, recent_window=4, prompt_compression_strategy=pcs,
              cache_bits=bits, **extra)
    jspec, tspec = JaxCacheSpec(**kw), CacheSpec(**kw)
    if strategy == "hybrid":
        hy = dict(token_ids_special=SPECIAL, token_ids_punc=PUNC)
        jspec = dataclasses.replace(
            jspec, hybrid_strategies=JH.normalize_hybrid_strategies(MENU), **hy)
        tspec = dataclasses.replace(
            tspec, hybrid_strategies=TH.normalize_hybrid_strategies(MENU), **hy)
    return (jspec,) * cfg.n_layer, (tspec,) * cfg.n_layer


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxModelConfig.from_name("TestTiny")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = ModelConfig.from_name("TestTiny")
    model = build_model(cfg, params_from_flat(_flatten(jparams), "cpu"), "cpu",
                        max_positions=128)
    return jcfg, jparams, cfg, model


def _jax_batch(jcfg, jparams, specs, prompts, n_new, dtype=jnp.float32, **kw):
    caches = JT.init_caches(jcfg, specs, len(prompts), dtype)
    params = JT.stack_layer_params(jparams) if JT.is_stacked(caches) else jparams
    return jax_generate_batch(jcfg, params, JT.make_rope_table(jcfg), caches, prompts, n_new,
                              **kw)


def _port_batch(cfg, model, specs, prompts, n_new, dtype=torch.float32, **kw):
    caches = TT.init_caches(cfg, specs, len(prompts), dtype, device="cpu")
    return generate_batch(model, caches, prompts, n_new, **kw)


def _assert_same(seqs, info, jseqs, jinfo, atol=1e-5):
    assert seqs == jseqs
    assert set(info["perf_stats"]) == set(jinfo["perf_stats"])
    assert info["prompt_lengths"] == jinfo["prompt_lengths"]
    assert info["num_generated"] == jinfo["num_generated"]
    for e, je in zip(info["emitted_probs"], jinfo["emitted_probs"]):
        np.testing.assert_allclose(e, je, rtol=0, atol=atol)
    np.testing.assert_allclose(info["final_probs"], np.asarray(jinfo["final_probs"]), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("case", list(CASES))
def test_generate_batch_matches_jax(tiny, case):
    jcfg, jparams, cfg, model = tiny
    jspecs, specs = _specs(cfg, case)
    jseqs, jinfo, _ = _jax_batch(jcfg, jparams, jspecs, PROMPTS, 8, prefill_bucket=64)
    before = kernel_launches()
    seqs, info, caches = _port_batch(cfg, model, specs, PROMPTS, 8, prefill_bucket=64)
    assert kernel_launches() == before  # CPU tensors: plain versions only
    _assert_same(seqs, info, jseqs, jinfo)
    assert info["perf_stats"]["batch_size"] == 3 and info["decode_steps"] == 7
    assert [s[:len(p)] for s, p in zip(seqs, PROMPTS)] == PROMPTS
    assert caches[0].pos.shape[0] == 3


def test_prompt_filling_the_smallest_cache_is_fed_through_decode(tiny):
    """A 24-token lane in 24-slot caches prefills 23 tokens and forces its
    last through decode (``forced_first``), beside a 20-token lane; with a
    terminator that one lane emits, as the JAX package does."""
    jcfg, jparams, cfg, model = tiny
    jspecs, specs = _specs(cfg, "heavy_hitter")
    prompts = [list(range(30, 54)), PROMPTS[0]]
    jseqs, jinfo, _ = _jax_batch(jcfg, jparams, jspecs, prompts, 8, prefill_bucket=32)
    seqs, info, _ = _port_batch(cfg, model, specs, prompts, 8, prefill_bucket=32)
    _assert_same(seqs, info, jseqs, jinfo)
    assert info["prompt_lengths"] == [23, 20]
    assert seqs[0][23] == prompts[0][-1]  # the fed token is lane 0's first output
    term = seqs[1][20 + 3]
    jseqs, jinfo, _ = _jax_batch(jcfg, jparams, jspecs, prompts, 8, prefill_bucket=32,
                                 terminator_ids=[term])
    seqs, info, _ = _port_batch(cfg, model, specs, prompts, 8, prefill_bucket=32,
                                terminator_ids=[term])
    _assert_same(seqs, info, jseqs, jinfo)
    assert seqs[1][-1] == term


# ---------------------------------------------------------------------------
# tests/test_batch.py, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["full", "recent_global", "l2", "heavy_hitter"])
def test_batched_matches_sequential(tiny, case):
    """Every lane of a batch equals its prompt's single-lane ``generate()``
    in the same bucket, and the lanes' caches hold the same positions."""
    _, _, cfg, model = tiny
    _, specs = _specs(cfg, case)
    singles, single_pos = [], []
    for p in PROMPTS:
        caches = TT.init_caches(cfg, specs, 1, torch.float32, device="cpu")
        seq, _, caches = generate(model, caches, p, 8, prefill_bucket=64)
        singles.append(seq)
        single_pos.append(caches[0].pos[0])
    seqs, info, caches = _port_batch(cfg, model, specs, PROMPTS, 8, prefill_bucket=64)
    assert info["perf_stats"]["batch_size"] == len(PROMPTS)
    for b, (got, want) in enumerate(zip(seqs, singles)):
        assert got == want, f"lane {b} diverged: {got} vs {want}"
        assert torch.equal(caches[0].pos[b], single_pos[b])


def test_batched_terminators_stop_lanes_independently(tiny):
    """Lane 0's third generated token as a terminator: lane 0 stops there
    and records nothing more, lane 1 runs on unchanged."""
    _, _, cfg, model = tiny
    _, specs = _specs(cfg, "recent_global")
    prompts = PROMPTS[:2]
    seqs, _, _ = _port_batch(cfg, model, specs, prompts, 8, prefill_bucket=64)
    lane0_gen = seqs[0][len(prompts[0]):]
    term = lane0_gen[2]
    seqs2, info2, _ = _port_batch(cfg, model, specs, prompts, 8, prefill_bucket=64,
                                  terminator_ids=[term])
    assert seqs2[0][len(prompts[0]):] == lane0_gen[:3], "lane 0 should stop at its terminator"
    assert info2["emitted_probs"][0][3:] == []
    if term not in seqs[1][len(prompts[1]):]:
        assert seqs2[1] == seqs[1], "lane 1 should be unaffected"
        assert info2["decode_steps"] == 7


#: One lane: its prompt, the index among the free-running generation's
#: tokens of the one given as a terminator (None: no terminator), and the
#: new tokens ``generate_batch`` is asked for where ``generate()`` is asked
#: for 6. The third prompt is as long as the 24-slot caches and feeds its
#: last token through decode: ``generate()`` adds that token to its new
#: tokens, ``generate_batch`` counts it among them, as the JAX package's do.
SINGLE_LANE = {
    "no_terminator": (PROMPTS[0], None, 6),
    "emitted_terminator": (PROMPTS[0], 2, 6),
    "fills_smallest_cache": (list(range(30, 54)), None, 7),
}


@pytest.mark.parametrize("case", list(SINGLE_LANE))
def test_batched_single_lane_matches_generate(tiny, case):
    """One lane through ``generate_batch`` equals ``generate()``: tokens,
    emitted probabilities, final distribution, every cache tensor to the bit
    and the kernel launches; and a second call after ``reset_caches``
    repeats it."""
    _, _, cfg, model = tiny
    _, specs = _specs(cfg, "recent_global")
    prompt, term_at, batch_new = SINGLE_LANE[case]
    kw = dict(prefill_bucket=32)
    if term_at is not None:
        caches = TT.init_caches(cfg, specs, 1, torch.float32, device="cpu")
        free, _, _ = generate(model, caches, prompt, 6, **kw)
        kw["terminator_ids"] = [free[len(prompt) + term_at]]
    runs = []
    for batch in (False, True):
        caches = TT.init_caches(cfg, specs, 1, torch.float32, device="cpu")
        before = kernel_launches()
        out = (generate_batch(model, caches, [prompt], batch_new, **kw) if batch
               else generate(model, caches, prompt, 6, **kw))
        runs.append((out, {k: n - before.get(k, 0) for k, n in kernel_launches().items()}))
    ((seq, info, caches), launches), ((seqs, binfo, bcaches), blaunches) = runs
    assert seqs[0] == seq
    assert binfo["prompt_lengths"] == [info["prompt_length"]]
    assert binfo["num_generated"] == [info["num_generated"]]
    np.testing.assert_array_equal(binfo["emitted_probs"][0], info["emitted_probs"])
    np.testing.assert_array_equal(binfo["final_probs"][0], info["final_probs"])
    for c, bc in zip(caches, bcaches):
        for t, bt in zip(c.tensors(), bc.tensors(), strict=True):
            assert t.dtype == bt.dtype and torch.equal(t, bt)
    assert blaunches == launches
    if term_at is not None:
        assert seq[-1] == kw["terminator_ids"][0] and info["num_generated"] < 6
    if case == "fills_smallest_cache":
        assert info["prompt_length"] == len(prompt) - 1 and seq[len(prompt) - 1] == prompt[-1]
    reset_caches(bcaches)
    again, _, _ = generate_batch(model, bcaches, [prompt], batch_new, **kw)
    assert again == seqs


def test_decode_positions_past_the_rope_table_raise(tiny):
    """The rope check reads the largest lane's last position."""
    _, _, cfg, model = tiny
    _, specs = _specs(cfg, "recent_global")
    caches = TT.init_caches(cfg, specs, 2, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="rope rows"):
        generate_batch(model, caches, [PROMPTS[0], list(range(1, 121))], 10,
                       prefill_bucket=128)


# ---------------------------------------------------------------------------
# TestKernel: int4 weights and head, kv8 heavy-hitter cache, two lanes,
# teacher-forced through the batched prefill and decode loop, against the
# TPU program in interpret mode
# ---------------------------------------------------------------------------

PROMPT = np.random.RandomState(0).randint(2, 500, size=300).tolist()
FORCED = np.random.RandomState(1).randint(2, 500, size=8).tolist()
#: bench.py's lanes: the prompt, and the prompt less 8 tokens.
KERNEL_PROMPTS = [PROMPT, PROMPT[:292]]
JAX_GATES = ("CCT_PALLAS_INTERPRET", "CCT_FUSED_EVICT", "CCT_TILED_HEAD",
             "CCT_PREFILL_W4A8", "CCT_QMM_CPT", "CCT_QMM_INKQ", "CCT_ATTN_I8DOT",
             "CCT_ATTN_V2", "CCT_ATTN_V2_OS_MB")
#: The bounds of tests/test_torch_generate.py's
#: ``test_int4_kv8_matches_tpu_program_in_interpret_mode[auto-1]`` at batch 1,
#: on lane 0's prompt and the same forced tokens: the prefill step's
#: probability, the later steps' (relative) and the final log-probabilities.
FIRST_RTOL, STEPS_RTOL, LOGP_TOL = 5e-3, 2e-2, 8e-2
#: The decode steps of a lane whose prompt compression parts from the TPU
#: program's at heavy-hitter near-ties (``_tie_swaps``): on lane 1 each
#: layer keeps one other position of its 128, and the steps then differ by
#: up to 3.63e-2 relative (ROADMAP section 3). The bound is the 5e-2 of the
#: XLA-path comparison (``test_int4_kv8_matches_jax_xla_path``).
NEAR_TIE_STEPS_RTOL = 5e-2


def _record_heavy_hitter_scores(monkeypatch):
    """Record the SnapKV prompt scores ([B, KVH, P]) of every layer's
    prompt compression, on the JAX side (through a debug callback, in
    order) and on the port's: the two lists."""
    from cold_compress_tpu.caches import prompt_compression as JPC

    from cold_compress_tpu_torch.caches import prompt_compression as TPC

    jrec, trec = [], []
    jfun = JPC.PromptCompressorHeavyHitter.token_importances.__func__
    tfun = TPC.PromptCompressorHeavyHitter.token_importances.__func__

    def jax_side(cls, *args, **kw):
        out = jfun(cls, *args, **kw)
        jax.debug.callback(lambda x: jrec.append(np.asarray(x, np.float64)), out, ordered=True)
        return out

    def port_side(cls, *args, **kw):
        out = tfun(cls, *args, **kw)
        trec.append(out.detach().double().numpy().copy())
        return out

    monkeypatch.setattr(JPC.PromptCompressorHeavyHitter, "token_importances",
                        classmethod(jax_side))
    monkeypatch.setattr(TPC.PromptCompressorHeavyHitter, "token_importances",
                        classmethod(port_side))
    return jrec, trec


def _tie_swaps(jrec, trec, lens, C):
    """Per lane, the prompt positions one side keeps among its C best
    scores and the other does not, summed over layers and heads. Each such
    position must be a near-tie: its score lies within the largest gap
    between the two sides' scores of that row from the cut-off (the C-th
    best score), on both sides, where the gap is measured over the
    positions the two sides agree on."""
    swaps = [0] * len(lens)
    for jl, tl in zip(jrec, trec):
        shape = (len(lens),) + jl.shape[1:]
        jl, tl = np.broadcast_to(jl, shape), np.broadcast_to(tl, shape)
        for b, P in enumerate(lens):
            for h in range(shape[1]):
                j, t = jl[b, h, :P], tl[b, h, :P]
                kept_j = set(np.argsort(-j, kind="stable")[:C].tolist())
                kept_t = set(np.argsort(-t, kind="stable")[:C].tolist())
                swapped = sorted(kept_j ^ kept_t)
                gap = float(np.abs(np.delete(j - t, swapped)).max())
                for score in (j, t):
                    cut = np.sort(score)[::-1][C - 1]
                    margins = [abs(float(score[i] - cut)) for i in swapped]
                    assert all(m <= gap for m in margins), \
                        f"lane {b} head {h}: margins {margins} to the cut-off exceed the gap {gap}"
                swaps[b] += len(swapped) // 2
    return swaps


def test_int4_kv8_batch_matches_tpu_program_in_interpret_mode(monkeypatch):
    """Both sides quantize activations to int8 and the cache to uint8; the
    port's decode attention takes its i8dot branch (``auto``) as the TPU
    program does by default. Each lane prefills its own length, then both
    decode the forced tokens from their own positions (the JAX package's
    ``_prefill_jit`` and ``_decode_loop_jit``, the port's ``prefill`` and
    ``decode_loop_core``); each lane of the port's batch equals the same
    lane run alone, bit for bit."""
    from cold_compress_tpu.runtime.generate import _decode_loop_jit, _prefill_jit

    from cold_compress_tpu_torch.runtime.generate import decode_loop_core

    jcfg = JaxModelConfig.from_name("TestKernel")
    qp = quantize_params(JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16),
                         mode="int4", group_size=128, output_mode="int4")
    kw = dict(cache_strategy="heavy_hitter", max_cache_length=128, max_seq_length=512,
              global_tokens=4, recent_window=10, prompt_compression_strategy="heavy_hitter",
              cache_bits=8)
    lens = [len(p) for p in KERNEL_PROMPTS]
    tokens = [p + [0] * (512 - len(p)) for p in KERNEL_PROMPTS]
    steps = len(FORCED) - 1
    for k in JAX_GATES:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("CCT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CCT_TILED_HEAD", "1")
    jrec, trec = _record_heavy_hitter_scores(monkeypatch)
    jax.clear_caches()
    try:
        p = JT.tile_output_head(JT.colpack_layer_params(
            JT.fuse_layer_params(JT.stack_layer_params(qp))))
        rope = JT.make_rope_table(jcfg)
        caches = JT.init_caches(jcfg, (JaxCacheSpec(**kw),) * jcfg.n_layer, 2, jnp.bfloat16)
        plen = jnp.asarray(lens, jnp.int32)
        _, jprobs, caches = _prefill_jit(jcfg, p, rope, caches, jnp.asarray(tokens, jnp.int32),
                                         plen)
        _, jbuf, n, jlast, _ = _decode_loop_jit(
            jcfg, p, rope, caches, jnp.asarray([FORCED[0]] * 2, jnp.int32), plen,
            jnp.asarray(FORCED[1:], jnp.int32), jnp.asarray([-7], jnp.int32), steps)
        assert int(n) == steps
        e_ref = np.concatenate([np.asarray(jprobs)[:, FORCED[0]][None], np.asarray(jbuf)])
        f_ref = np.asarray(jlast)
    finally:
        jax.clear_caches()

    cfg = ModelConfig.from_name("TestKernel")
    model = build_model(cfg, params_from_flat(_flatten(qp), "cpu"), "cpu", max_positions=512)
    caches = TT.init_caches(cfg, (CacheSpec(**kw),) * cfg.n_layer, 2, torch.bfloat16,
                            device="cpu")
    with torch.inference_mode():
        probs = torch.softmax(TT.prefill(model, caches, torch.tensor(tokens),
                                         torch.tensor(lens, dtype=torch.int32)), dim=-1)
    out, buf, last, n, _ = decode_loop_core(model, caches, torch.tensor([FORCED[0]] * 2), lens,
                                            FORCED[1:], [], steps)
    assert n == steps and out[1:].tolist() == [[t, t] for t in FORCED[1:]]
    assert caches[0].k.dtype == torch.uint8 and int(caches[0].cache_ct.max()) == 128
    e = np.concatenate([probs[:, FORCED[0]].numpy()[None], buf.numpy()])
    last = last.clone()
    jax.effects_barrier()
    assert len(jrec) == len(trec) == cfg.n_layer
    swaps = _tie_swaps(jrec, trec, lens, kw["max_cache_length"])
    assert swaps[0] == 0, "lane 0 (batch 1's prompt) must keep the TPU program's positions"
    for b, prompt in enumerate(KERNEL_PROMPTS):
        alone = TT.init_caches(cfg, (CacheSpec(**kw),) * cfg.n_layer, 1, torch.bfloat16,
                               device="cpu")
        _, info, _ = generate(model, alone, prompt, len(FORCED), prefill_bucket=512,
                              next_tokens=FORCED)
        np.testing.assert_array_equal(e[:, b], info["emitted_probs"])
        np.testing.assert_array_equal(last[b].numpy(), info["final_probs"])
    for b in range(2):
        np.testing.assert_allclose(e[0, b], e_ref[0, b], rtol=FIRST_RTOL)
        np.testing.assert_allclose(e[:, b], e_ref[:, b],
                                   rtol=NEAR_TIE_STEPS_RTOL if swaps[b] else STEPS_RTOL)
        f = last[b].numpy()
        assert np.all(f > 0) and abs(float(f.sum()) - 1.0) < 1e-3
        assert float(np.abs(np.log(f) - np.log(f_ref[b])).max()) <= LOGP_TOL
