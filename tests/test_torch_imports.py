"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points refuse to run on the CPU unless asked to."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cold_compress_tpu_torch
from cold_compress_tpu_torch import resolve_device
from cold_compress_tpu_torch.models.config import ModelConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "cold_compress_tpu_torch"


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages([str(PORT)], prefix="cold_compress_tpu_torch.")
    )


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter, importing every module of the port leaves
    ``jax`` and ``cold_compress_tpu`` out of ``sys.modules``."""
    mods = _port_modules()
    assert len(mods) >= 15, mods
    parallel = {f"cold_compress_tpu_torch.parallel.{m}"
                for m in ("launch", "mesh", "tp_decode", "sp", "pp")}
    assert parallel <= set(mods), sorted(parallel - set(mods))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'cold_compress_tpu' or m.startswith('cold_compress_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_optional_packages_load_lazily():
    """Importing every module loads none of the tokenizer packages nor
    PyYAML: the wrappers import theirs in their constructors, the cache
    config overlay when it reads a file."""
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in ('sentencepiece', 'tiktoken', 'transformers', 'yaml')\n"
        "             if m in sys.modules)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_import_in_source(path):
    """AST scan: no ``import jax``, no import of the JAX package and none of
    the repository's root scripts in the port or in chip_smoke.py (lazy
    imports inside functions included)."""
    root_scripts = {p.stem for p in REPO.glob("*.py")}
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top != "jax", f"{path}: imports {name}"
        assert top != "cold_compress_tpu", f"{path}: imports {name}"
        assert top not in root_scripts, f"{path}: imports the root script {name}"


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """With no card and no explicit ``device="cpu"``, the entry points raise
    instead of continuing on the CPU."""
    from cold_compress_tpu_torch import convert_hf_checkpoint, eval_multi, generate, quantize
    from cold_compress_tpu_torch import eval as port_eval
    from cold_compress_tpu_torch.caches import CacheSpec
    from cold_compress_tpu_torch.models.transformer import init_caches, init_params
    from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params
    from cold_compress_tpu_torch.runtime.engine import (
        build_model, load_model, params_from_flat, save_params,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig.from_name("TestKernel")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    flat = random_quantized_params(cfg, seed=0)
    with pytest.raises(RuntimeError):
        params_from_flat(flat)
    params = params_from_flat(flat, "cpu")
    with pytest.raises(RuntimeError):
        build_model(cfg, params)
    specs = [CacheSpec(max_cache_length=16, max_seq_length=16)] * cfg.n_layer
    with pytest.raises(RuntimeError):
        init_caches(cfg, specs)
    with pytest.raises(RuntimeError):
        init_params(cfg)
    path = tmp_path / "TestKernel" / "model.npz"
    save_params(init_params(cfg, device="cpu"), path)
    with pytest.raises(RuntimeError):
        load_model(path)
    with pytest.raises(RuntimeError):
        quantize.main(["--checkpoint_path", str(path), "--mode", "int4"])
    with pytest.raises(RuntimeError):
        generate.main(["--checkpoint_path", str(path), "--prompt", "hi"])
    eval_argv = ["--checkpoint_path", str(path), "--tasks", "rulerniah", "--num_samples", "1",
                 "--out_dir", str(tmp_path / "eval"), "--cache_strategy", "l2",
                 "--prompt_compression_strategy", "l2"]
    with pytest.raises(RuntimeError):
        port_eval.cli(eval_argv)
    with pytest.raises(RuntimeError):
        eval_multi.main(eval_argv)
    with pytest.raises(RuntimeError):
        convert_hf_checkpoint.main(["--checkpoint_dir", str(tmp_path / "hf" / "TestKernel")])
    assert load_model(path, device="cpu")[0].name == "TestKernel"
    assert resolve_device("cpu") == torch.device("cpu")
    assert isinstance(cold_compress_tpu_torch.MODEL_CONFIGS, dict)
    assert np.isfinite(cfg.norm_eps)
