"""The port's HF checkpoint converter against the JAX package's
(``scripts/convert_hf_checkpoint.py``), on the two trained fixtures'
``config.json`` and ``model.safetensors``: the same keys, dtype tags,
shapes and bytes, also from sharded safetensors and a ``.bin`` file; the
file loads in both packages."""

import importlib.util
import json
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from cold_compress_tpu_torch.convert_hf_checkpoint import (
    convert_hf_checkpoint,
    permute_rope,
    read_safetensors,
)
from cold_compress_tpu_torch.runtime.engine import load_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = ["TinyByteLM-hf", "TinyByteLM128-hf"]


def _jax_converter():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_hf_checkpoint", REPO / "scripts" / "convert_hf_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _checkpoint_dir(tmp_path, side, name, files=("config.json", "model.safetensors")):
    d = tmp_path / side / name
    d.mkdir(parents=True)
    for f in files:
        shutil.copy(REPO / "tests" / "fixtures" / name / f, d / f)
    return d


def _write_safetensors(path, tensors):
    """A safetensors file: the header's length, the header, the bytes."""
    names = {torch.bfloat16: "BF16", torch.float32: "F32", torch.float16: "F16"}
    header, blobs, offset = {}, [], 0
    for key, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[key] = {"dtype": names[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    Path(path).write_bytes(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def _assert_same_npz(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("name", FIXTURES)
def test_output_equals_the_jax_converters(tmp_path, name):
    jax_dir = _checkpoint_dir(tmp_path, "jax", name)
    port_dir = _checkpoint_dir(tmp_path, "port", name)
    _jax_converter().convert_hf_checkpoint(jax_dir)
    out = convert_hf_checkpoint(port_dir, device="cpu")
    assert out == port_dir / "model.npz"
    _assert_same_npz(jax_dir / "model.npz", out)
    # The fixture's own model.npz was written by the JAX converter.
    _assert_same_npz(REPO / "tests" / "fixtures" / name / "model.npz", out)
    keys = np.load(out).files
    assert "tok_embeddings#bf16" in keys and "layers/0/attn/wq#bf16" in keys
    assert convert_hf_checkpoint(port_dir, device="cpu") == out  # an existing file stays


def test_loads_in_both_packages(tmp_path):
    from cold_compress_tpu.runtime.engine import load_params as jax_load_params

    out = convert_hf_checkpoint(_checkpoint_dir(tmp_path, "port", FIXTURES[1]), device="cpu")
    port = load_params(out, "cpu")
    ref = jax_load_params(str(out))
    for key in ("wq", "wk", "wv", "wo"):
        got = port["layers"][3]["attn"][key]
        want = np.asarray(ref["layers"][3]["attn"][key], np.float32)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert port["output"] is not None and ref["output"] is not None


def test_sharded_and_bin_checkpoints(tmp_path):
    """The fixture's tensors split over two safetensors shards with an
    index, and the same tensors in a ``pytorch_model.bin``: each converts
    to the single file's output (and, sharded, to the JAX converter's)."""
    name = FIXTURES[1]
    single = convert_hf_checkpoint(_checkpoint_dir(tmp_path, "single", name), device="cpu")
    tensors = read_safetensors(REPO / "tests" / "fixtures" / name / "model.safetensors")
    keys = sorted(tensors)
    half = len(keys) // 2
    for side in ("port", "jax"):
        d = _checkpoint_dir(tmp_path, f"sharded_{side}", name, files=("config.json",))
        shards = {"model-00001-of-00002.safetensors": keys[:half],
                  "model-00002-of-00002.safetensors": keys[half:]}
        for fname, part in shards.items():
            _write_safetensors(d / fname, {k: tensors[k] for k in part})
        (d / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: f for f, part in shards.items() for k in part}}))
        if side == "port":
            _assert_same_npz(single, convert_hf_checkpoint(d, device="cpu"))
        else:
            _jax_converter().convert_hf_checkpoint(d)
            _assert_same_npz(single, d / "model.npz")
    d = _checkpoint_dir(tmp_path, "bin", name, files=("config.json",))
    torch.save(tensors, d / "pytorch_model.bin")
    _assert_same_npz(single, convert_hf_checkpoint(d, device="cpu"))


def test_reader_and_permutation_match_the_libraries():
    """``read_safetensors`` against the ``safetensors`` package;
    ``permute_rope`` against the JAX converter's, weights and biases."""
    from safetensors.torch import load_file

    path = REPO / "tests" / "fixtures" / FIXTURES[0] / "model.safetensors"
    got, want = read_safetensors(path), load_file(str(path))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    ref = _jax_converter().permute_rope
    rng = np.random.RandomState(0)
    for shape, heads in (((4 * 16, 24), 4), ((2 * 16,), 2)):
        w = rng.randn(*shape).astype(np.float32)
        np.testing.assert_array_equal(permute_rope(torch.from_numpy(w), heads, 16).numpy(),
                                      ref(w, heads, 16))
