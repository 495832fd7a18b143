"""Cases of the port's sequence- and pipeline-parallel CPU tests
(``tests/test_torch_sp.py``, ``tests/test_torch_pp.py``): ``tests/
test_sp.py``'s cases (f32 TestTiny, a 128-token bucket with a padded tail,
numpy-seeded tokens, the JAX package's weights carried across through the
checkpoint key scheme), the JAX package's parallel prefill of each on the
suite's eight host devices, and the port's ranks of each (gloo, started
once per module, ``tests/torch_ranks.py``).

Bounds, each a share of the largest reference element, with the largest
gaps measured on the CPU: ``LOGIT_REL`` 1e-5 on logits (3.8e-7), ``KV_REL``
2.5e-4 on the cached K/V (5.2e-5: pipeline chunks round a layer's bf16
attention output at other elements than one pass does, one bf16 unit apart,
and the next layer's K/V carries it), ``INT4_REL`` 3e-2 for int4 weights
(6.9e-3 logits, 8.8e-3 K/V): the port's 32-row shards take the W4A8
projection (activations quantized to int8, as the TPU program does at 32
rows) where the JAX package's CPU run dequantizes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cold_compress_tpu.caches import CacheSpec as JaxCacheSpec
from cold_compress_tpu.models import transformer as JT
from cold_compress_tpu.models.config import ModelConfig as JaxModelConfig
from cold_compress_tpu.parallel.pp import make_pp_mesh as jax_pp_mesh
from cold_compress_tpu.parallel.pp import pp_prefill as jax_pp_prefill
from cold_compress_tpu.parallel.sp import make_sp_mesh as jax_sp_mesh
from cold_compress_tpu.parallel.sp import make_sp_tp_mesh as jax_sp_tp_mesh
from cold_compress_tpu.parallel.sp import sp_prefill as jax_sp_prefill
from cold_compress_tpu.parallel.sp import sp_tp_prefill as jax_sp_tp_prefill
from cold_compress_tpu.quantization.weight_quant import quantize_params
from cold_compress_tpu.runtime.engine import _flatten
from cold_compress_tpu.runtime.engine import build_cache_specs as jax_build_specs

from cold_compress_tpu_torch.caches import CacheSpec
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.parallel import mesh
from cold_compress_tpu_torch.parallel.launch import launch, run_jobs
from cold_compress_tpu_torch.runtime.engine import build_cache_specs
from torch_ranks import prefill_and_decode

P_LEN = 128
N_DECODE = 6
LOGIT_REL = 1e-5
KV_REL = 2.5e-4
INT4_REL = 3e-2
HYBRID_KW = {
    "cache_strategy": ["hybrid"], "max_cache_length": [1.0],
    "prompt_compression_strategy": ["full"], "global_tokens": 2,
    "hybrid_strategies": [{"strategy": "window", "recent_window": 0.1},
                          {"strategy": "special_punc_heavy_hitter", "heavy_hitter_frac": 0.25},
                          {"strategy": "full"}],
    "min_recovery_frac": 0.85,
}
HYBRID_IDS = {"special": [[256], [257]], "punctuation": [46, 44, 33]}


def tokens(seed):
    toks = np.random.RandomState(seed).randint(5, 512 - 5, size=P_LEN)
    if seed == 3:  # the hybrid case: specials and punctuation exercise the masks
        toks[[4, 30, 77]] = 256
        toks[[10, 50, 90]] = 46
    return toks.tolist()


#: name: (layout, strategy, cache length, compressor, token seed, padding,
#: weights); tests/test_sp.py's cases (sp x tp at 2 x 2 for four ranks).
CASES = {
    "sp4_full": (mesh.Layout(sp=4), "full", 128, "full", 0, 7, "f32"),
    "sp4_heavy_hitter": (mesh.Layout(sp=4), "heavy_hitter", 64, "heavy_hitter", 0, 7, "f32"),
    "sp4_recent_global": (mesh.Layout(sp=4), "recent_global", 64, "recent_global", 0, 7, "f32"),
    "sp4_hybrid": (mesh.Layout(sp=4), "hybrid", 128, "full", 3, 7, "f32"),
    "sp4_int4": (mesh.Layout(sp=4), "heavy_hitter", 64, "heavy_hitter", 4, 8, "int4"),
    "sp2tp2_heavy_hitter": (mesh.Layout(sp=2, tp=2), "heavy_hitter", 64, "heavy_hitter", 1, 5,
                            "f32"),
    "sp2tp2_full": (mesh.Layout(sp=2, tp=2), "full", 128, "full", 1, 5, "f32"),
    "pp2_heavy_hitter": (mesh.Layout(pp=2), "heavy_hitter", 64, "heavy_hitter", 2, 9, "f32"),
    "pp2_full": (mesh.Layout(pp=2), "full", 128, "full", 2, 9, "f32"),
}


@functools.lru_cache(maxsize=None)
def weights(kind):
    """(JAX config, port config, JAX params, flat checkpoint dict)."""
    jcfg = JaxModelConfig.from_name("TestTiny")
    params = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    if kind == "int4":
        params = quantize_params(params, mode="int4", group_size=32)
    return jcfg, ModelConfig.from_name("TestTiny"), params, _flatten(params)


def specs(case, port: bool):
    _, strategy, C, compressor, _, _, _ = CASES[case]
    jcfg, cfg = weights("f32")[:2]
    if strategy == "hybrid":
        if port:
            return build_cache_specs(cfg, HYBRID_KW, P_LEN, token_ids=HYBRID_IDS)
        return jax_build_specs(jcfg, HYBRID_KW, P_LEN, token_ids=HYBRID_IDS)
    make = CacheSpec if port else JaxCacheSpec
    return [make(cache_strategy=strategy, max_cache_length=C, max_seq_length=256,
                 global_tokens=4, recent_window=8, prompt_compression_strategy=compressor)
            for _ in range(cfg.n_layer)]


@functools.lru_cache(maxsize=None)
def jax_reference(case):
    """The JAX package's parallel prefill of the case on the host devices:
    (logits, stacked caches, greedy tokens of six decode steps)."""
    layout, strategy, _, _, seed, pad, kind = CASES[case]
    jcfg, _, params, _ = weights(kind)
    params_s = JT.stack_layer_params(params)
    rope = JT.make_rope_table(jcfg)
    caches = JT.init_caches(jcfg, tuple(specs(case, False)), 1, jnp.float32)
    ids = jnp.asarray([tokens(seed)], jnp.int32)
    plen = jnp.int32(P_LEN - pad)
    if layout.pp > 1:
        logits, caches = jax_pp_prefill(jcfg, params_s, rope, caches, ids, plen,
                                        jax_pp_mesh(layout.pp), chunk=32)
    elif layout.tp > 1:
        logits, caches = jax_sp_tp_prefill(jcfg, params_s, rope, caches, ids, plen,
                                           jax_sp_tp_mesh(layout.sp, layout.tp))
    else:
        logits, caches = jax_sp_prefill(jcfg, params_s, rope, caches, ids, plen,
                                        jax_sp_mesh(layout.sp))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks, state = [int(tok[0])], caches
    for i in range(N_DECODE):
        out, state = JT.decode_step(jcfg, params_s, rope, state, tok, plen + i)
        tok = jnp.argmax(out, axis=-1).astype(jnp.int32)
        toks.append(int(tok[0]))
    return np.asarray(logits), caches, toks


def within(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap, tol = float(np.abs(got - want).max()), rel * float(np.abs(want).max())
    print(f"{what}: max gap {gap:.3e} ({gap / max(float(np.abs(want).max()), 1e-30):.2e} of the "
          f"largest), bound {tol:.3e}")
    assert gap <= tol, f"{what}: {gap:.3e} apart, bound {tol:.3e}"




def launch_cases(names, extra_jobs=()):
    """Every named case's per-rank results (and each extra job's, under its
    name), from one world of four gloo ranks."""
    jobs = []
    for name in names:
        layout, _, _, _, seed, pad, kind = CASES[name]
        _, cfg, _, flat = weights(kind)
        jobs.append((layout, prefill_and_decode,
                     (cfg, flat, specs(name, True), tokens(seed), P_LEN - pad, N_DECODE)))
    jobs += [job for _, job in extra_jobs]
    per_rank = launch(run_jobs, jobs, dp=4, device="cpu", timeout_s=120)
    names = list(names) + [name for name, _ in extra_jobs]
    return {name: [r[j] for r in per_rank] for j, name in enumerate(names)}


def check_case(ranks, case):
    """Every rank of the case against the JAX package's function of the
    same layout: logits, exact kept positions and masks (and hybrid's
    policies), the cached K/V (each tp rank holds its KV heads), and the
    greedy tokens of six decode steps (f32 weights)."""
    layout, strategy, _, _, _, _, kind = CASES[case]
    want_logits, want_caches, want_toks = jax_reference(case)
    results = [r for r in ranks[case] if r is not None]
    assert len(results) == layout.world
    for rank, (logits, state, toks) in enumerate(results):
        within(logits, want_logits, INT4_REL if kind == "int4" else LOGIT_REL,
               f"{case} rank {rank} logits")
        kvh = state[0]["k"].shape[1]
        heads = slice(rank % layout.tp * kvh, (rank % layout.tp + 1) * kvh)
        for layer, got in enumerate(state):
            def pick(x):
                return np.asarray(x)[layer][:, heads]

            np.testing.assert_array_equal(got["pos"], pick(want_caches.pos), err_msg=case)
            np.testing.assert_array_equal(got["mask"], pick(want_caches.mask), err_msg=case)
            if strategy == "hybrid":
                np.testing.assert_array_equal(got["strategy_idx"],
                                              pick(want_caches.extra["strategy_idx"]))
            for key in ("k", "v"):
                within(got[key], pick(getattr(want_caches, key)),
                       INT4_REL if kind == "int4" else KV_REL,
                       f"{case} rank {rank} layer {layer} {key}")
        if kind != "int4":
            assert toks == want_toks, f"{case} rank {rank}: {toks} != JAX {want_toks}"
