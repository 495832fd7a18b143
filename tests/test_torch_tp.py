"""The port's tensor and data parallelism (``cold_compress_tpu_torch/parallel``)
against the JAX package's ``parallel/tp_decode.py`` (``prepare_tp`` and
``generate(tp_ctx=)``; the port's model holds its context), on the same
numpy-seeded prompts and weights carried across through the checkpoint key
scheme.

The port's ranks are processes (gloo on the CPU). They are started once
for the whole module (``launch(run_jobs, ...)``: four ranks, each case a
job of its own (dp, tp) layout over them) and run only the port; the JAX
references run here, on the suite's eight host devices. Tokens are equal
in f32. Teacher-forced probabilities are held within a share of the
largest compared one: 2e-2 in bf16 at tp = 4 (the sum order of four
partial sums differs) and 5e-2 for int4 layers (row-parallel W4A8
quantizes activations per local input segment), the JAX package's numbers
for the same comparisons (``tests/test_tp_kernels.py``), there absolute.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.models import transformer as JT
from cold_compress_tpu.models.config import ModelConfig as JaxModelConfig
from cold_compress_tpu.ops.linear import dequantize_weight
from cold_compress_tpu.parallel import tp_decode as jtp
from cold_compress_tpu.quantization.weight_quant import quantize_params
from cold_compress_tpu.runtime.engine import _flatten
from cold_compress_tpu.runtime.engine import build_cache_specs as jax_build_specs
from cold_compress_tpu.runtime.generate import generate as jax_generate
from cold_compress_tpu.runtime.generate import generate_batch as jax_generate_batch

from cold_compress_tpu_torch import generate as port_cli
from cold_compress_tpu_torch.models import transformer as TT
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.ops.qmm import dequantize_gemv, rowpack_to_gemv
from cold_compress_tpu_torch.parallel import tp_decode as ptp
from cold_compress_tpu_torch.parallel.launch import launch, run_jobs
from cold_compress_tpu_torch.parallel.mesh import Layout
from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model, params_from_flat
from cold_compress_tpu_torch.runtime.generate import generate
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HH_KW = {
    "cache_strategy": ["heavy_hitter"],
    "max_cache_length": [0.25],
    "prompt_compression_strategy": ["heavy_hitter"],
    "global_tokens": 4,
    "recent_window": 10,
}
HH8_KW = {**HH_KW, "cache_bits": 8}
PROMPT = np.random.RandomState(2).randint(2, 500, size=200).tolist()
FORCED = np.random.RandomState(3).randint(2, 500, size=8).tolist()
PROMPT_TINY = np.random.RandomState(5).randint(1, 500, size=90).tolist()
BATCH_PROMPTS = [PROMPT[:120], PROMPT[:77], PROMPT[:150], PROMPT[:50]]
# TestTiny widened as tests/test_tp_cli.py widens it; TestKernel widened as
# tests/test_tp_kernels.py does (tp = 2 divides the KV heads, head_dim 128).
TINY_WIDE = dict(n_head=8, n_kv_head=4, dim=128, intermediate_size=256)
KERNEL_WIDE = dict(dim=512, n_head=4, n_kv_head=2)
KERNEL_FOUR = dict(dim=512, n_head=4, n_kv_head=4)
# Bounds on probabilities, as a share of the largest compared one (the
# measured gaps on the CPU in brackets): bf16 at tp = 4 against JAX's tp = 4
# (0.5% emitted, 0.6% final); int4 with a kv8 cache at tp = 2 against JAX's
# tp = 2 and against the port's single process (1.1% and 1.2% emitted, 2.3%
# and 2.2% final); int4 at tp = 2 against JAX's GSPMD tp = 2 (1.2%, 1.1%).
TP4_REL = 2e-2
INT4_REL = 5e-2


def _cfgs(name, widen):
    return JaxModelConfig.from_name(name).replace(**widen), ModelConfig.from_name(name).replace(
        **widen)


@functools.lru_cache(maxsize=None)
def _weights(case):
    """(JAX config, port config, JAX params, their flat checkpoint dict) of
    each case."""
    if case == "tiny_f32":
        jcfg, cfg = _cfgs("TestTiny", TINY_WIDE)
        params = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    elif case == "four_bf16":
        jcfg, cfg = _cfgs("TestKernel", KERNEL_FOUR)
        params = JT.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    elif case == "int4":
        jcfg, cfg = _cfgs("TestKernel", KERNEL_WIDE)
        params = quantize_params(JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16),
                                 mode="int4", group_size=128, output_mode="int4")
    else:  # "kernel_f32"
        jcfg, cfg = _cfgs("TestKernel", KERNEL_WIDE)
        params = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, cfg, params, _flatten(params)


def _job(tp, dp, case, prompts, new_tokens, kw, max_seq, dtype, **gen_kw):
    """A ``run_jobs`` job: ``rank_generate`` on the case's weights."""
    _, cfg, _, flat = _weights(case)
    fn = functools.partial(ptp.rank_generate, max_seq_length=max_seq, dtype=dtype,
                           build_kw={"max_positions": max_seq}, **gen_kw)
    return (Layout(tp=tp, dp=dp), fn, (cfg, flat, kw, prompts, new_tokens))


JOBS = {  # name: (tp, dp, case, prompts, new tokens, cache options, max seq, dtype, options)
    "tp2_tiny": (2, 1, "tiny_f32", PROMPT_TINY, 16, HH_KW, 128, torch.float32, {}),
    "tp4_bf16": (4, 1, "four_bf16", PROMPT, 8, HH_KW, 512, torch.bfloat16,
                 {"next_tokens": FORCED, "prefill_bucket": 512}),
    "tp2_int4": (2, 1, "int4", PROMPT, 8, HH8_KW, 512, torch.bfloat16,
                 {"next_tokens": FORCED, "prefill_bucket": 512}),
    "dp2_tp2": (2, 2, "kernel_f32", BATCH_PROMPTS, 8, HH_KW, 512, torch.float32,
                {"prefill_bucket": 512, "batch": True}),
}


@pytest.fixture(scope="module")
def ranks():
    """Every job's per-rank results, from one run of four gloo ranks."""
    names = list(JOBS)
    jobs = [_job(tp, dp, case, p, n, kw, ms, dt, **opts)
            for tp, dp, case, p, n, kw, ms, dt, opts in (JOBS[k] for k in names)]
    per_rank = launch(run_jobs, jobs, tp=4, device="cpu", timeout_s=120)
    return {name: [r[j] for r in per_rank] for j, name in enumerate(names)}


def _within(got, want, rel: float, what: str) -> None:
    """Probabilities ``got`` within ``rel`` of the largest of ``want``. Over
    a 512-token vocabulary with random weights each probability is near
    2e-3, so a bound that does not scale with them would pass anything."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    gap, tol = float(np.abs(got - want).max()), rel * float(np.abs(want).max())
    print(f"{what}: max gap {gap:.3e}, bound {tol:.3e}")
    assert gap <= tol, f"{what}: {gap:.3e} apart, bound {tol:.3e}"


def _jax_caches(jcfg, kw, max_seq, dtype, batch=1):
    return JT.init_caches(jcfg, jax_build_specs(jcfg, kw, max_seq), batch, dtype)


def _port_single(case, kw, max_seq, dtype, prompt, new_tokens, **gen_kw):
    _, cfg, _, flat = _weights(case)
    model = build_model(cfg, params_from_flat(flat, "cpu"), "cpu", max_positions=max_seq)
    caches = TT.init_caches(cfg, build_cache_specs(cfg, kw, max_seq), 1, dtype, device="cpu")
    seq, info, _ = generate(model, caches, prompt, new_tokens, **gen_kw)
    return seq, info


def _jax_tp(case, tp, kw, max_seq, dtype, prompt, new_tokens, dp=1, batch=False, **gen_kw):
    jcfg, _, params, _ = _weights(case)
    ctx = jtp.prepare_tp(jcfg, params, tp, dp=dp)
    rope = JT.make_rope_table(jcfg)
    run = jax_generate_batch if batch else jax_generate
    caches = _jax_caches(jcfg, kw, max_seq, dtype, len(prompt) if batch else 1)
    seq, info, _ = run(jcfg, params, rope, caches, prompt, new_tokens, tp_ctx=ctx, **gen_kw)
    return seq, info


# ---------------------------------------------------------------------------
# The shards, leaf for leaf
# ---------------------------------------------------------------------------


def _port_dense(leaf) -> np.ndarray:
    if isinstance(leaf, dict) and leaf.get("kind") == "int8":
        return (leaf["w"].float() * leaf["scales"].float()[None, :]).numpy()
    if isinstance(leaf, dict):
        wg, sz = rowpack_to_gemv(leaf["w"], leaf["scales"], leaf["zeros"])
        return dequantize_gemv(wg, sz, leaf["group_size"], torch.float32).numpy()
    return leaf.float().numpy()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["int4", "int8", "dense"])
def test_shards_match_jax_leaf_for_leaf(kind, tp):
    """Every rank's column-parallel (wq, wk, wv, w1, w3), row-parallel (wo,
    w2) and vocab-head shard, dequantized, equals the JAX package's
    ``_col_local``/``_row_local``/``_head_local`` of the same leaf (which
    repacks int4 into its colpack layout first) exactly."""
    jcfg, cfg = _cfgs("TestKernel", KERNEL_FOUR)
    params = JT.init_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.bfloat16)
    if kind != "dense":
        params = quantize_params(params, mode=kind, group_size=128, output_mode=kind)
    port = params_from_flat(_flatten(params), "cpu")
    layer, player = params["layers"][0], port["layers"][0]
    for t in range(tp):
        for group in ("attn", "ffn"):
            for name, jleaf in layer[group].items():
                if name in ptp._COL:
                    want, got = jtp._col_local(jleaf, t, tp), ptp._col_local(player[group][name], t, tp)
                else:
                    want, got = jtp._row_local(jleaf, t, tp), ptp._row_local(player[group][name], t, tp)
                np.testing.assert_array_equal(_port_dense(got),
                                              np.asarray(dequantize_weight(want, jnp.float32)),
                                              err_msg=f"{group}/{name} shard {t} of {tp}")
        want = jtp._head_local(params["output"], t, tp)
        got = ptp._head_local(port["output"], t, tp)
        np.testing.assert_array_equal(_port_dense(got),
                                      np.asarray(dequantize_weight(want, jnp.float32)))
    shard = ptp.prepare_tp(cfg, port, tp, tp - 1)
    assert ptp.local_cfg(cfg, tp).head_dim == cfg.head_dim
    assert "wq" in shard["layers"][0]["attn"] and "wqkv" not in shard["layers"][0]["attn"]


def test_unaligned_group_and_indivisible_tp_raise():
    """A row-parallel int4 shard whose input rows split a quantization group
    raises, as in the JAX package; so does a tp that does not divide the KV
    heads, and a fused tree."""
    jcfg, cfg = _cfgs("TestKernel", KERNEL_FOUR)
    params = quantize_params(JT.init_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.bfloat16),
                             mode="int4", group_size=128)
    wo = params_from_flat(_flatten(params), "cpu")["layers"][0]["attn"]["wo"]  # IN = 512
    with pytest.raises(ValueError, match="must align to quantization groups"):
        ptp._row_local(wo, 0, 8)
    with pytest.raises(AssertionError, match="must align to quantization groups"):
        jtp._row_local(params["layers"][0]["attn"]["wo"], 0, 8)
    with pytest.raises(ValueError, match="must divide n_kv_head=4"):
        ptp.prepare_tp(cfg, params_from_flat(_flatten(params), "cpu"), 8, 0)
    fused = TT.fuse_layer_params(params_from_flat(_flatten(params), "cpu"))
    with pytest.raises(ValueError, match="do not fuse_layer_params before it"):
        ptp.prepare_tp(cfg, fused, 2, 0)


# ---------------------------------------------------------------------------
# Generation across ranks
# ---------------------------------------------------------------------------


def test_tp2_f32_tiny_tokens_equal_jax_tp_and_port_single(ranks):
    """f32 TestTiny (widened), heavy_hitter at 25% of 128 over a 90-token
    prompt, 16 greedy tokens: both ranks' tokens equal the JAX package's
    tp = 2 run and the port's single-process run."""
    (seq0, info0), (seq1, _) = ranks["tp2_tiny"][:2]
    jseq, jinfo = _jax_tp("tiny_f32", 2, HH_KW, 128, jnp.float32, PROMPT_TINY, 16)
    single, sinfo = _port_single("tiny_f32", HH_KW, 128, torch.float32, PROMPT_TINY, 16)
    assert seq0 == seq1 == jseq == single
    np.testing.assert_allclose(info0["emitted_probs"], jinfo["emitted_probs"], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(info0["emitted_probs"], sinfo["emitted_probs"], rtol=1e-3,
                               atol=1e-5)
    assert ranks["tp2_tiny"][2:] == [None, None]  # ranks 2 and 3 sat this job out


def test_tp4_bf16_teacher_forced_matches_jax_tp4(ranks):
    """bf16 TestKernel with four KV heads over four ranks, teacher-forced
    (``test_tp_bf16_four_way``'s configuration): every rank's probabilities
    against the JAX package's tp = 4 run, within 2e-2 of the largest."""
    jseq, jinfo = _jax_tp("four_bf16", 4, HH_KW, 512, jnp.bfloat16, PROMPT, 8,
                          next_tokens=FORCED, prefill_bucket=512)
    for seq, info in ranks["tp4_bf16"]:
        assert seq == jseq
        _within(info["emitted_probs"], jinfo["emitted_probs"], TP4_REL, "tp4 emitted")
        _within(info["final_probs"], jinfo["final_probs"], TP4_REL, "tp4 final")


def test_tp2_int4_kv8_matches_jax_interpret_and_single_card(ranks, monkeypatch):
    """int4 layers and head, a kv8 heavy_hitter cache, TestKernel widened,
    teacher-forced: the port's tp = 2 against the JAX package's tp = 2 with
    its Pallas kernels in interpret mode, and against the port's single
    process, both within 5e-2 of the largest probability
    (``test_tp_int4_kernels_match_single_device``'s number)."""
    monkeypatch.setenv("CCT_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    jseq, jinfo = _jax_tp("int4", 2, HH8_KW, 512, jnp.bfloat16, PROMPT, 8,
                          next_tokens=FORCED, prefill_bucket=512)
    monkeypatch.delenv("CCT_PALLAS_INTERPRET")
    jax.clear_caches()
    single, sinfo = _port_single("int4", HH8_KW, 512, torch.bfloat16, PROMPT, 8,
                                 next_tokens=FORCED, prefill_bucket=512)
    (seq, info), (seq1, info1) = ranks["tp2_int4"][:2]
    assert seq == seq1 == jseq == single
    assert info["emitted_probs"] == info1["emitted_probs"]
    _within(info["emitted_probs"], jinfo["emitted_probs"], INT4_REL, "int4 emitted vs JAX tp")
    _within(info["final_probs"], jinfo["final_probs"], INT4_REL, "int4 final vs JAX tp")
    _within(info["emitted_probs"], sinfo["emitted_probs"], INT4_REL, "int4 emitted vs single")
    _within(info["final_probs"], sinfo["final_probs"], INT4_REL, "int4 final vs single")


def test_dp2_tp2_batch_tokens_equal_jax(ranks):
    """``generate_batch`` over four lanes on a (dp = 2, tp = 2) layout, f32
    (``test_dp_tp_batched_matches_single``): every rank returns all four
    lanes, in lane order, equal to the JAX package's dp = 2 x tp = 2 run."""
    jseqs, _ = _jax_tp("kernel_f32", 2, HH_KW, 512, jnp.float32, BATCH_PROMPTS, 8, dp=2,
                       batch=True, prefill_bucket=512)
    for seqs, info in ranks["dp2_tp2"]:
        assert seqs == jseqs
        assert info["prompt_lengths"] == [len(p) for p in BATCH_PROMPTS]
        assert info["final_probs"].shape == (4, 512)
        assert info["perf_stats"]["batch_size"] == 4


def _generation(out: str) -> str:
    return re.split(r"=+", out.split("GENERATION:")[1])[0].strip()


def test_generate_cli_tp2_matches_tp1(capsys):
    """``generate --tp 2 --tp_kernels --device cpu`` (two gloo ranks)
    prints the generation of ``--tp 1``."""
    argv = ["--device", "cpu", "--random_weights", "TestTiny", "--prompt", "tell me a story",
            "--max_new_tokens", "12", "--cache_strategy", "recent_global",
            "--max_cache_length", "0.5", "--global_tokens", "2"]
    assert port_cli.main([*argv, "--tp", "1"]) == 0
    base = _generation(capsys.readouterr().out)
    assert port_cli.main([*argv, "--tp", "2", "--tp_kernels"]) == 0
    tp2 = _generation(capsys.readouterr().out)
    assert tp2 == base and len(base) > 0


def test_eval_dp2_writes_the_predictions_of_one_replica(tmp_path):
    """The port's ``eval --tp 2 --dp 2 --batch_size 4`` (four gloo ranks,
    two lanes per replica) writes the files of ``--tp 2`` alone (two ranks,
    four lanes): dp only splits the lanes; rank 0 alone writes. (The bf16
    partial sums of ``--tp 2`` part from ``--tp 1`` at near-ties;
    ``test_tp2_f32_tiny_tokens_equal_jax_tp_and_port_single`` holds tp to
    tp = 1 in f32.)"""
    from cold_compress_tpu_torch import eval as port_eval

    def run(out, extra):
        argv = ["--device", "cpu", "--random_weights", "TestTinyLong", "--tasks", "rulerniah",
                "--num_samples", "4", "--batch_size", "4", "--ruler_context_sentences", "4",
                "--cache_strategy", "heavy_hitter", "--prompt_compression_strategy",
                "heavy_hitter", "--max_cache_length", "0.5", "--out_dir", str(tmp_path / out),
                "--tp", "2", "--tp_kernels", *extra]
        assert port_eval.cli(argv) == 0
        return tmp_path / out  # an absolute --out_dir is the directory itself

    one, two = run("dp1", []), run("dp2", ["--dp", "2"])
    for name in ("rulerniah_predictions.csv", "rulerniah_args.json"):
        assert (two / name).read_text() == (one / name).read_text(), name
    assert sorted(p.name for p in two.iterdir()) == sorted(p.name for p in one.iterdir())


def test_tp2_int4_within_bound_of_jax_gspmd_tp(ranks):
    """``--tp 2`` without ``--tp_kernels`` is the JAX package's GSPMD path
    (``parallel/mesh.py::shard_model``), which dequantizes int4 to bf16
    under XLA; the port has no GSPMD and runs its per-rank kernels (W4A8)
    for either flag. That deviation is bounded as the other int4 case is:
    the port's teacher-forced tp = 2 probabilities within 5e-2 of the
    largest of the GSPMD run's (measured 1.2%;
    ``test_tp_int4_xla_fallback_matches`` holds the JAX pair at an absolute
    2e-2, which these probabilities, near 2e-3, would always meet)."""
    from cold_compress_tpu.parallel.mesh import shard_model

    jcfg, _, params, _ = _weights("int4")
    caches = _jax_caches(jcfg, HH8_KW, 512, jnp.bfloat16)
    _, sharded, caches = shard_model(jcfg, JT.stack_layer_params(params), caches, tp=2)
    jseq, jinfo, _ = jax_generate(jcfg, sharded, JT.make_rope_table(jcfg), caches, PROMPT, 8,
                                  next_tokens=FORCED, prefill_bucket=512)
    seq, info = ranks["tp2_int4"][0]
    assert seq == jseq
    _within(info["emitted_probs"], jinfo["emitted_probs"], INT4_REL, "emitted vs GSPMD")
    _within(info["final_probs"], jinfo["final_probs"], INT4_REL, "final vs GSPMD")


def test_a_failing_rank_makes_the_launch_raise():
    """Ranks that raise (here ``validate_tp`` on TestTiny's two KV heads at
    tp = 4) stop the run: the parent raises with their error, and no rank
    is left waiting."""
    from torch.multiprocessing import ProcessRaisedException

    _, cfg, _, flat = _weights("tiny_f32")
    narrow = ModelConfig.from_name("TestTiny")
    run = functools.partial(ptp.rank_generate, max_seq_length=128, dtype=torch.float32)
    with pytest.raises(ProcessRaisedException, match="must divide n_kv_head=2"):
        launch(run, narrow, flat, HH_KW, PROMPT_TINY, 2, tp=4, device="cpu", timeout_s=60)
