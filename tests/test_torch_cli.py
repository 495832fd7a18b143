"""The port's command lines and checkpoint IO against the JAX package's:
``save_params``/``load_params`` files both ways, ``quantize`` byte for byte,
the cache-config overlay on every file of ``cache_configs/``, and the
``generate`` CLI against the JAX package's ``generate()`` on the same
checkpoint."""

import argparse
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantize as root_quantize
from cold_compress_tpu.models import transformer as JT
from cold_compress_tpu.models.config import ModelConfig as JaxModelConfig
from cold_compress_tpu.quantization import weight_quant as JW
from cold_compress_tpu.runtime import engine as JE
from cold_compress_tpu.runtime.generate import generate as jax_generate
from cold_compress_tpu.utils import cli as jax_cli

from cold_compress_tpu_torch import generate as cli
from cold_compress_tpu_torch import quantize as port_quantize
from cold_compress_tpu_torch.models import transformer as TT
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.ops import kernel_launches
from cold_compress_tpu_torch.quantization import weight_quant as TW
from cold_compress_tpu_torch.runtime import engine as TE
from cold_compress_tpu_torch.utils import cli as port_cli
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "cache_configs").glob("*.yaml"))


def _same_files(a, b):
    """Two .npz files hold the same keys with byte-identical arrays."""
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for key in fa.files:
            x, y = fa[key], fb[key]
            assert (x.dtype, x.shape) == (y.dtype, y.shape), key
            assert x.tobytes() == y.tobytes(), key


def _jax_params(kind, name="TestKernel"):
    cfg = JaxModelConfig.from_name(name)
    params = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    if kind == "bf16":
        return params
    return JW.quantize_params(params, mode=kind, group_size=128, output_mode=kind)


# ---------------------------------------------------------------------------
# Checkpoint IO
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_jax_checkpoint_round_trips_through_the_port(kind, tmp_path):
    """A file the JAX package writes, read by the port and written again,
    holds the same keys and bytes."""
    src, dst = tmp_path / "jax.npz", tmp_path / "port.npz"
    JE.save_params(_jax_params(kind), str(src))
    TE.save_params(TE.load_params(src, "cpu"), dst)
    _same_files(src, dst)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_port_checkpoint_round_trips_through_jax(kind, tmp_path):
    """A file the port writes (its ``init_params``, quantized by its
    ``quantize_params``), read by the JAX package's ``load_params`` and
    written again, holds the same keys and bytes."""
    cfg = ModelConfig.from_name("TestKernel")
    params = TT.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    if kind != "bf16":
        params = TW.quantize_params(params, mode=kind, output_mode=kind)
    src, dst = tmp_path / "port.npz", tmp_path / "jax.npz"
    TE.save_params(params, src)
    JE.save_params(JE.load_params(str(src)), str(dst))
    _same_files(src, dst)


def test_init_params_and_model_size_match_jax():
    """``init_params``: JAX's shapes, dtypes and key order; 0.02 N(0, 1)
    values; ``model_size_bytes`` equal on the same checkpoint."""
    cfg = ModelConfig.from_name("TestKernel")
    ours = TE.flatten_params(TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    ref = JE._flatten(_jax_params("bf16"))
    assert list(ours) == list(ref)
    for key in ref:
        assert (ours[key].dtype, ours[key].shape) == (ref[key].dtype, ref[key].shape), key
    emb = TE.params_from_flat(ours, "cpu")["tok_embeddings"].float()
    assert abs(float(emb.std()) - 0.02) < 1e-3
    for kind in ("bf16", "int8", "int4"):
        jp = _jax_params(kind)
        assert TT.model_size_bytes(TE.params_from_flat(JE._flatten(jp), "cpu")) == \
            JT.model_size_bytes(jp), kind


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_cli_matches_root_quantize(mode, tmp_path):
    """The port's ``quantize`` and the repository's ``quantize.py`` on the
    same TestKernel ``model.npz``: the same file name and the same bytes,
    key by key."""
    params = _jax_params("bf16")
    for side in ("jax", "port"):
        JE.save_params(params, str(tmp_path / side / "TestKernel" / "model.npz"))
    root_quantize.quantize(tmp_path / "jax" / "TestKernel" / "model.npz", mode)
    out = port_quantize.quantize(tmp_path / "port" / "TestKernel" / "model.npz", mode,
                                 device="cpu")
    name = "model_int8.npz" if mode == "int8" else "model_int4.g128.npz"
    assert out == tmp_path / "port" / "TestKernel" / name
    _same_files(tmp_path / "jax" / "TestKernel" / name, out)


@pytest.mark.parametrize("in_dim,out_dim,gs", [(288, 96, 128), (512, 64, 64), (100, 40, 128)])
def test_quantize_weight_bytes_match_jax(in_dim, out_dim, gs):
    """f32 true divisions, round half to even, ``zeros = mn + 8 scales`` in
    f32 before the bf16 cast, and the effective group size of dims that are
    no multiple of 128: the JAX functions' bytes on the same f32 input."""
    rng = np.random.RandomState(in_dim)
    w = (rng.randn(in_dim, out_dim) * 0.05).astype(np.float32)
    w[0, :4] = [0.0, 0.0, 0.0, 1.0]  # a column with ties
    ref8 = JE._flatten(JW.quantize_weight_int8(jnp.asarray(w)))
    ref4 = JE._flatten(JW.quantize_weight_int4(jnp.asarray(w), group_size=gs))
    got8 = TE.flatten_params(TW.quantize_weight_int8(torch.from_numpy(w)))
    got4 = TE.flatten_params(TW.quantize_weight_int4(torch.from_numpy(w), group_size=gs))
    for ref, got in ((ref8, got8), (ref4, got4)):
        assert sorted(ref) == sorted(got)
        for key in ref:
            assert ref[key].dtype == got[key].dtype and ref[key].tobytes() == got[key].tobytes(), key


def test_unknown_mode_raises(tmp_path):
    with pytest.raises(ValueError, match="Invalid quantization mode"):
        port_quantize.quantize(tmp_path / "TestKernel" / "model.npz", "int2", device="cpu")


# ---------------------------------------------------------------------------
# Cache-config overlay
# ---------------------------------------------------------------------------


def _parse(module, argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cache_config", default=None)
    module.add_generation_arguments(parser)
    module.add_cache_arguments(parser)
    return parser.parse_args(argv)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_cache_config_overlay_matches_jax(path):
    """Every ``cache_configs`` file overlays the same options as the JAX
    package's ``merge_cache_config``, and yields the same per-layer cache
    specs."""
    argv = ["--cache_config", path.stem, "--max_cache_length", "0.25", "--cache_bits", "8"]
    ours = vars(port_cli.merge_cache_config(_parse(port_cli, argv)))
    ref = vars(jax_cli.merge_cache_config(_parse(jax_cli, argv)))
    for key in ("device", "checkpoint_path", "help"):
        ours.pop(key, None), ref.pop(key, None)
    for key in ("tp", "sp", "pp", "dp", "tp_kernels", "profile", "compile", "model_name"):
        assert ours.pop(key) == ref.pop(key), key
    # The port's flag for the JAX package's CCT_ATTN_I8DOT environment variable.
    assert ours.pop("attn_i8dot") == "auto"
    assert ours == ref
    cfg_j = JaxModelConfig.from_name("TestKernel")
    token_ids = {"special": [[256], [257]], "punctuation": [32, 33, 46]}
    specs = TE.build_cache_specs(ModelConfig.from_name("TestKernel"), ours, 512, token_ids)
    ref_specs = JE.build_cache_specs(cfg_j, ref, 512, token_ids)
    # Field by field (the hybrid menu entries are each package's own class).
    assert [{k: repr(v) for k, v in vars(s).items()} for s in specs] == [
        {k: repr(v) for k, v in vars(s).items()} for s in ref_specs]


def test_missing_cache_config_or_yaml_reader_raises(monkeypatch):
    """An unknown config name raises, and so does a missing PyYAML: it never
    means "no overlay"."""
    import sys

    with pytest.raises(FileNotFoundError):
        port_cli.merge_cache_config(_parse(port_cli, ["--cache_config", "no_such_config"]))
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError
    with pytest.raises(ImportError):
        port_cli.merge_cache_config(_parse(port_cli, ["--cache_config", "heavy_hitter"]))


@pytest.mark.parametrize("argv", [["--tp", "2"], ["--sp", "4", "--pp", "2"], ["--pp", "3"],
                                  ["--dp", "2"], ["--tp", "2", "--tp_kernels"]])
def test_parallel_flags_raise(argv):
    """The JAX package's refusals for TestKernel (two layers, one KV head):
    ``--pp`` runs alone; ``--pp`` must divide the layers; ``--dp`` shards
    lanes, which one prompt has not; a ``--tp`` that does not divide the
    one KV head raises ``validate_tp``'s message, with or without
    ``--tp_kernels``. (``--sp 4`` and ``--pp 2`` alone run:
    ``tests/test_torch_pp.py``.)"""
    match = {"--tp": "must divide n_kv_head=1", "--dp": "shards batch lanes",
             "--sp": "--pp runs alone", "--pp": "n_layer 2 % pp 3 != 0"}[argv[0]]
    with pytest.raises(ValueError, match=match):
        cli.parse_args(["--device", "cpu", "--random_weights", "TestKernel", *argv])


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.parse_args(["--random_weights", "TestKernel", "--prompt", "hi"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run(args)


# ---------------------------------------------------------------------------
# The generate CLI end to end
# ---------------------------------------------------------------------------

PROMPT_TEXT = (REPO / "prompts" / "long_prompt_short_output.txt").read_text()[:400]
JAX_GATES = ("CCT_PALLAS_INTERPRET", "CCT_FUSED_EVICT", "CCT_TILED_HEAD", "CCT_PREFILL_W4A8",
             "CCT_QMM_CPT", "CCT_QMM_INKQ", "CCT_ATTN_I8DOT", "CCT_ATTN_V2", "CCT_ATTN_V2_OS_MB")


@pytest.fixture(scope="module")
def int4_checkpoint(tmp_path_factory):
    """TestKernel quantized by the repository's ``quantize.py --mode int4``
    under a ``byte`` path (the byte tokenizer, no tokenizer file)."""
    root = tmp_path_factory.mktemp("ckpt") / "byte" / "TestKernel"
    JE.save_params(_jax_params("bf16"), str(root / "model.npz"))
    root_quantize.quantize(root / "model.npz", "int4")
    return root / "model_int4.g128.npz"


def test_cli_run_on_pyramid_matches_jax_generate(int4_checkpoint, monkeypatch, capsys):
    """``--cache_config heavy_hitter_pyramid --max_cache_length 0.25
    --cache_bits 8`` on an int4 checkpoint: per-layer budgets, so the JAX
    package keeps its caches unstacked and its int4 leaves rowpack (the
    rowpack kernel K10, in interpret mode). The port's greedy tokens,
    teacher-forced through JAX's ``generate()``: emitted probabilities
    within 3% relative and final log-probabilities within 8e-2, as in
    tests/test_torch_generate.py (the heavy-hitter near-ties noted there)."""
    args = cli.parse_args(["--device", "cpu", "--checkpoint_path", str(int4_checkpoint),
                           "--cache_config", "heavy_hitter_pyramid", "--max_cache_length",
                           "0.25", "--cache_bits", "8", "--max_new_tokens", "8",
                           "--prompt", PROMPT_TEXT])
    before = kernel_launches()
    seq, info, caches = cli.run(args)
    assert kernel_launches() == before  # CPU tensors: plain versions only
    lengths = [c.spec.max_cache_length for c in caches]
    assert len(set(lengths)) == 2 and caches[0].k.dtype == torch.uint8
    P = info["prompt_length"]
    assert P == len(PROMPT_TEXT.strip().encode()) + 1  # BOS + bytes (an "instruct"-free path)
    gen = seq[P:]
    assert len(gen) == info["num_generated"] and "Time to load model" in capsys.readouterr().out

    for key in JAX_GATES:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("CCT_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    cfg, params, rope = JE.load_model(int4_checkpoint)
    specs = JE.build_cache_specs(cfg, vars(args), P + 8)
    assert [s.max_cache_length for s in specs] == lengths
    caches_j = JT.init_caches(cfg, specs, 1)
    assert not JT.is_stacked(caches_j)
    jseq, jinfo, _ = jax_generate(cfg, params, rope, caches_j, seq[:P], len(gen),
                                  next_tokens=gen, terminator_ids=[257])
    jax.clear_caches()
    assert jseq == seq
    e, e_ref = np.asarray(info["emitted_probs"]), np.asarray(jinfo["emitted_probs"])
    np.testing.assert_allclose(e[0], e_ref[0], rtol=5e-3)
    np.testing.assert_allclose(e, e_ref, rtol=3e-2)
    f, f_ref = np.asarray(info["final_probs"]), np.asarray(jinfo["final_probs"])
    assert float(np.abs(np.log(f) - np.log(f_ref)).max()) <= 8e-2


def test_cli_main_prints_every_section(capsys):
    """``main`` over random weights: the JAX CLI's four output sections."""
    assert cli.main(["--device", "cpu", "--random_weights", "TestKernel", "--prompt",
                     "The quick brown fox", "--max_new_tokens", "4", "--cache_strategy",
                     "heavy_hitter", "--prompt_compression_strategy", "heavy_hitter",
                     "--max_cache_length", "0.5", "--compile"]) == 0
    out = capsys.readouterr().out
    for section in ("GENERATION:", "PERFORMANCE:", "DETAILED PERFORMANCE:",
                    "KV CACHE STATISTICS:", "Decode Toks Per Sec", "Compression Ratio By Layer"):
        assert section in out, section


def test_cli_truncates_an_over_long_prompt(int4_checkpoint, capsys):
    """The default prompt file (50k bytes) is cut to block_size minus the
    new tokens, as the JAX CLI cuts it."""
    args = cli.parse_args(["--device", "cpu", "--checkpoint_path", str(int4_checkpoint),
                           "--max_new_tokens", "4", "--cache_strategy", "recent_global",
                           "--max_cache_length", "0.25"])
    seq, info, _ = cli.run(args)
    assert "truncating to 508 tokens" in capsys.readouterr().out
    assert info["prompt_length"] == 508 and len(seq) == 512


# ---------------------------------------------------------------------------
# Tokenizer, sequence lengths and stats printing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["byte", "ckpt/byte/Meta-Llama-3-8B-Instruct/model.npz",
                                  "TestTiny", "Test-Tiny"])
def test_byte_tokenizer_matches_jax(name):
    """"byte" anywhere in the name (or TestTiny) selects the byte tokenizer,
    which encodes, decodes and classifies tokens as the JAX package's."""
    from cold_compress_tpu import tokenizer as jax_tok
    from cold_compress_tpu_torch import tokenizer as port_tok

    ours, ref = port_tok.get_tokenizer(None, name), jax_tok.get_tokenizer(None, name)
    assert isinstance(ours, port_tok.ByteTokenizer) and isinstance(ref, jax_tok.ByteTokenizer)
    text = PROMPT_TEXT[:200] + " café, naïve!"
    for is_chat in (True, False):
        ids = port_tok.encode(ours, text, is_chat=is_chat)
        assert ids == jax_tok.encode(ref, text, is_chat=is_chat)
        assert ours.decode(ids) == ref.decode(ids)
    assert ours.special_ids() == ref.special_ids()
    assert ours.punctuation_ids() == ref.punctuation_ids()
    assert ours.get_terminator_ids() == ref.get_terminator_ids() and len(ours) == len(ref)


@pytest.mark.parametrize("name,package", [("Meta-Llama-3-8B-Instruct", "tiktoken"),
                                          ("Llama-2-7b-chat-hf", "sentencepiece"),
                                          ("Qwen2-7B-Instruct", "transformers")])
def test_tokenizer_wrappers_import_their_packages_when_built(name, package, monkeypatch,
                                                             tmp_path):
    """A missing tokenizer package raises where its wrapper is built."""
    import sys

    from cold_compress_tpu_torch.tokenizer import get_tokenizer

    monkeypatch.setitem(sys.modules, package, None)  # import <package> raises ImportError
    with pytest.raises(ImportError):
        get_tokenizer(tmp_path / "tokenizer.model", name)


def test_sequence_lengths_and_load_model_match_jax(tmp_path):
    """``compute_max_seq_length`` (clamped to the block size),
    ``min_cache_length`` over per-layer specs, and ``load_model``'s
    architecture from the parent directory or ``model_name``."""
    cfg, jcfg = ModelConfig.from_name("TestKernel"), JaxModelConfig.from_name("TestKernel")
    for lens, new in (([10, 300], 16), ([600], 4), ([500], 12)):
        assert TE.compute_max_seq_length(cfg, lens, new) == \
            JE.compute_max_seq_length(jcfg, lens, new)
    argv = ["--cache_config", "heavy_hitter_pyramid", "--max_cache_length", "0.25"]
    ours = vars(port_cli.merge_cache_config(_parse(port_cli, argv)))
    ref = vars(jax_cli.merge_cache_config(_parse(jax_cli, argv)))
    assert TE.min_cache_length(TE.build_cache_specs(cfg, ours, 512)) == \
        JE.min_cache_length(JE.build_cache_specs(jcfg, ref, 512))
    path = tmp_path / "TestKernel" / "model.npz"
    TE.save_params(TT.init_params(cfg, device="cpu"), path)
    assert TE.load_model(path, device="cpu")[0].name == "TestKernel"
    renamed = tmp_path / "elsewhere" / "model.npz"
    renamed.parent.mkdir()
    path.rename(renamed)
    got_cfg, params = TE.load_model(renamed, model_name="TestKernel", device="cpu")
    assert got_cfg.name == "TestKernel" and params["norm"].dtype == torch.bfloat16


def test_print_stats_matches_jax(capsys):
    from cold_compress_tpu.runtime.stats import print_stats as jax_print_stats
    from cold_compress_tpu_torch.runtime.stats import print_stats

    stats = {"decode_toks_per_sec": 12.3456, "compression_ratio_0": 0.25,
             "compression_ratio_1": 0.5, "compression_ratio_avg": 0.375,
             "cache_memory_gb": 1.0, "strategy": "heavy_hitter", "x_10": 3.0, "x_2": 1.0}
    print_stats(stats)
    ours = capsys.readouterr().out
    jax_print_stats(stats)
    assert ours == capsys.readouterr().out
    assert "Compression Ratio By Layer: 0=0.25, 1=0.50" in ours and "Strategy: heavy_hitter" in ours
