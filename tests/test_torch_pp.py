"""The port's pipeline parallelism (``parallel/pp.py::pp_prefill``), its
2-D sequence x tensor parallelism (``parallel/sp.py::sp_tp_prefill``) and
the multi-node rank layout (``parallel/mesh.py::check_node_layout``)
against the JAX package's ``pp_prefill`` (chunk 32) and ``sp_tp_prefill``
on ``tests/test_sp.py``'s cases (``tests/parallel_cases.py``: the cases,
their bounds and the gaps measured), over four gloo ranks started once for
the module and declared as two nodes of two; the generate CLI at
``--sp 2``, ``--pp 2`` and ``--sp 2 --tp 2`` against ``--sp 1``; and the
JAX package's refusals.
"""

import contextlib
import functools
import io
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cold_compress_tpu_torch import generate as port_cli
from cold_compress_tpu_torch.caches import CacheSpec
from cold_compress_tpu_torch.models.transformer import init_caches
from cold_compress_tpu_torch.parallel import mesh
from cold_compress_tpu_torch.parallel.pp import pp_prefill
from cold_compress_tpu_torch.parallel.sp import sp_tp_prefill
from cold_compress_tpu_torch.parallel.tp_decode import build_rank_model, rank_generate
from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model, params_from_flat
from cold_compress_tpu_torch.runtime.generate import generate_batch
from parallel_cases import check_case, launch_cases, specs, weights
from torch_ranks import context_error
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASES = ["pp2_heavy_hitter", "pp2_full", "sp2tp2_heavy_hitter", "sp2tp2_full"]
MULTINODE_PROMPTS = [np.random.RandomState(6).randint(2, 500, size=n).tolist()
                     for n in (90, 70, 110, 50)]
MULTINODE_KW = {"cache_strategy": ["heavy_hitter"], "max_cache_length": [0.5],
                "prompt_compression_strategy": ["heavy_hitter"], "global_tokens": 4}




@pytest.fixture(scope="module")
def ranks():
    """Every case's per-rank results, the multi-node (dp = 2, tp = 2)
    ``generate_batch`` job's and each rank's error for a tp = 4 context,
    from four gloo ranks declared as two nodes of two (``torchrun``'s
    ``LOCAL_WORLD_SIZE`` = 2)."""
    _, cfg, _, flat = weights("f32")
    job = (mesh.Layout(tp=2, dp=2),
           functools.partial(rank_generate, max_seq_length=256, dtype=torch.float32,
                             batch=True, build_kw={"max_positions": 256}),
           (cfg, flat, MULTINODE_KW, MULTINODE_PROMPTS, 8))
    with pytest.MonkeyPatch.context() as env:  # the spawned ranks inherit it
        env.setenv("LOCAL_WORLD_SIZE", "2")
        return launch_cases(CASES, [("multinode", job), ("tp_across_nodes", (
            mesh.Layout(dp=4), context_error, (mesh.Layout(tp=4),)))])


@pytest.mark.parametrize("case", CASES)
def test_parallel_prefill_matches_jax(ranks, case):
    """pp = 2 (chunks of 32 rows) and sp = 2 x tp = 2 over f32 TestTiny
    (heavy_hitter, full): every rank against the JAX package's
    ``pp_prefill`` / ``sp_tp_prefill`` (``parallel_cases.check_case``)."""
    check_case(ranks, case)


def test_multinode_layout_dp2_tp2_matches_single_process(ranks):
    """Four ranks as two nodes of two: tp = 2 within each node, dp = 2
    across them (the counterpart of ``scripts/multiproc_dryrun.py``);
    ``generate_batch``'s four lanes equal the single process's."""
    _, cfg, _, flat = weights("f32")
    model = build_model(cfg, params_from_flat(flat, "cpu"), "cpu", max_positions=256)
    caches = init_caches(cfg, build_cache_specs(cfg, MULTINODE_KW, 256), 4, torch.float32,
                         device="cpu")
    want, _, _ = generate_batch(model, caches, MULTINODE_PROMPTS, 8)
    for seqs, _ in ranks["multinode"]:
        assert seqs == want


def test_multinode_layout_refuses_tp_across_nodes(ranks):
    """tp = 4 over nodes of two ranks: the JAX package's ``make_mesh``
    message, with the node and NVLink for the host and ICI; every rank's
    context raises it, before any collective."""
    errors = ranks["tp_across_nodes"]
    assert len(errors) == 4
    for err in errors:
        assert err is not None and "tp=4 must fit within one node's 2 ranks" in err, err
    with pytest.raises(ValueError, match="tp=3 must fit within one node's 4 ranks"):
        mesh.check_node_layout(3, 2, 4)
    mesh.check_node_layout(2, 4, 4)  # two tp groups per node
    mesh.check_node_layout(8, 1, 8)  # one node


def _generation(out: str) -> str:
    return re.split(r"=+", out.split("GENERATION:")[1])[0].strip()


CLI_ARGV = ["--device", "cpu", "--random_weights", "TestTiny", "--prompt",
            "tell me a story about a long walk by the sea", "--max_new_tokens", "10",
            "--cache_strategy", "heavy_hitter", "--prompt_compression_strategy", "heavy_hitter",
            "--max_cache_length", "0.5", "--global_tokens", "2"]


@functools.lru_cache(maxsize=None)
def _sp1_generation():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_cli.main([*CLI_ARGV, "--sp", "1"]) == 0
    return _generation(out.getvalue())


@pytest.mark.parametrize("flags", [["--sp", "2"], ["--pp", "2"], ["--sp", "2", "--tp", "2"]])
def test_generate_cli_parallel_matches_sp1(flags, capsys):
    """``python -m cold_compress_tpu_torch.generate`` at ``--sp 2``,
    ``--pp 2`` and ``--sp 2 --tp 2`` (gloo ranks) prints the generation of
    ``--sp 1``, as ``tests/test_tp_cli.py`` holds the JAX CLI."""
    base = _sp1_generation()
    assert port_cli.main([*CLI_ARGV, *flags]) == 0
    assert _generation(capsys.readouterr().out) == base and len(base) > 0


def test_refusals_keep_the_jax_messages():
    """pp over a hybrid cache, over heterogeneous per-layer specs, over
    layers it does not divide; sp x tp over quantized weights; batched
    lanes under sp or pp."""
    _, cfg, _, flat = weights("f32")
    model = build_model(cfg, params_from_flat(flat, "cpu"), "cpu", max_positions=256)
    tokens = torch.zeros((1, 64), dtype=torch.long)
    hybrid = init_caches(cfg, specs("sp4_hybrid", True), 1, torch.float32, device="cpu")
    mixed = init_caches(cfg, [CacheSpec(max_cache_length=64), CacheSpec(max_cache_length=32)],
                        1, torch.float32, device="cpu")
    for pp, caches, match in ((2, hybrid, "hybrid profiling needs full attention maps"),
                              (2, mixed, "wants the stacked cache layout"),
                              (3, mixed, "n_layer 2 % pp 3 != 0")):
        model.pp = SimpleNamespace(pp=pp, rank=0)
        with pytest.raises(ValueError, match=match):
            pp_prefill(model, caches, tokens, 60)
    _, _, _, flat4 = weights("int4")
    q4 = build_model(cfg, params_from_flat(flat4, "cpu"), "cpu", max_positions=256)
    with pytest.raises(ValueError, match="dense weights only"):
        sp_tp_prefill(q4, mixed, tokens, 60)
    sp_ctx = mesh.SpContext(sp=2, tp=2, rank=0, backend="gloo", device=torch.device("cpu"))
    with pytest.raises(ValueError, match="requires dense"):
        build_rank_model(cfg, params_from_flat(flat4, "cpu"), sp_ctx)
    model.pp, model.sp = None, sp_ctx
    with pytest.raises(ValueError, match="single-lane runs"):
        generate_batch(model, mixed, [[1, 2, 3]], 2)
    model.sp, model.pp = None, SimpleNamespace(pp=2, rank=0)
    with pytest.raises(ValueError, match="--pp runs alone"):
        generate_batch(model, mixed, [[1, 2, 3]], 2)
