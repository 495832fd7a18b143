"""Convert a HuggingFace checkpoint to the ``.npz`` that both packages load.

Counterpart of ``scripts/convert_hf_checkpoint.py`` with numpy and torch
only: safetensors files (single, or sharded through ``*.index.json``) are
read directly (an 8-byte header length, a JSON header, then raw little-endian
tensors, each viewed as its type by ``torch``, bf16 included), so
neither ``safetensors`` nor ``ml_dtypes`` is needed; ``pytorch_model.bin``
and Meta's ``original/consolidated.00.pth`` load with ``torch.load``. q/k/v
stay separate and weights are transposed to [in, out]; q and k (weights
and Qwen2 biases) move from HF's half-split RoPE layout to interleaved pairs
(``permute_rope``), Meta's files are interleaved already; a missing
``lm_head`` ties the head to the embeddings; every leaf is stored bf16.
The casts and permutations run on the card unless ``--device cpu`` is
given.
``runtime/engine.py::save_params`` writes the file, so the port's and the
JAX package's loaders both read it.

    python -m cold_compress_tpu_torch.convert_hf_checkpoint \\
        --checkpoint_dir checkpoints/meta-llama/Meta-Llama-3-8B-Instruct
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import struct
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .models.config import ModelConfig
from .runtime.engine import save_params

HF_WEIGHT_MAP = {
    "model.embed_tokens.weight": "tok_embeddings",
    "model.layers.{}.self_attn.q_proj.weight": ("layers.{}.attn.wq", "w"),
    "model.layers.{}.self_attn.k_proj.weight": ("layers.{}.attn.wk", "w"),
    "model.layers.{}.self_attn.v_proj.weight": ("layers.{}.attn.wv", "w"),
    "model.layers.{}.self_attn.o_proj.weight": ("layers.{}.attn.wo", "w"),
    "model.layers.{}.self_attn.q_proj.bias": ("layers.{}.attn.bq", "b"),
    "model.layers.{}.self_attn.k_proj.bias": ("layers.{}.attn.bk", "b"),
    "model.layers.{}.self_attn.v_proj.bias": ("layers.{}.attn.bv", "b"),
    "model.layers.{}.self_attn.rotary_emb.inv_freq": None,
    "model.layers.{}.mlp.gate_proj.weight": ("layers.{}.ffn.w1", "w"),
    "model.layers.{}.mlp.up_proj.weight": ("layers.{}.ffn.w3", "w"),
    "model.layers.{}.mlp.down_proj.weight": ("layers.{}.ffn.w2", "w"),
    "model.layers.{}.input_layernorm.weight": "layers.{}.attention_norm",
    "model.layers.{}.post_attention_layernorm.weight": "layers.{}.ffn_norm",
    "model.norm.weight": "norm",
    "lm_head.weight": ("output", "w"),
}

# Meta "original" format (Llama-3 consolidated.pth): already RoPE-interleaved.
META_WEIGHT_MAP = {
    "tok_embeddings.weight": "tok_embeddings",
    "layers.{}.attention.wq.weight": ("layers.{}.attn.wq", "w_nopermute"),
    "layers.{}.attention.wk.weight": ("layers.{}.attn.wk", "w_nopermute"),
    "layers.{}.attention.wv.weight": ("layers.{}.attn.wv", "w_nopermute"),
    "layers.{}.attention.wo.weight": ("layers.{}.attn.wo", "w_nopermute"),
    "layers.{}.feed_forward.w1.weight": ("layers.{}.ffn.w1", "w_nopermute"),
    "layers.{}.feed_forward.w3.weight": ("layers.{}.ffn.w3", "w_nopermute"),
    "layers.{}.feed_forward.w2.weight": ("layers.{}.ffn.w2", "w_nopermute"),
    "layers.{}.attention_norm.weight": "layers.{}.attention_norm",
    "layers.{}.ffn_norm.weight": "layers.{}.ffn_norm",
    "norm.weight": "norm",
    "output.weight": ("output", "w"),
    "rope.freqs": None,
}

#: safetensors dtype names and the torch dtypes their bytes hold.
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU (the file is
    mapped; each tensor's bytes are copied once)."""
    data = np.memmap(path, dtype=np.uint8, mode="r")
    (header_len,) = struct.unpack("<Q", data[:8].tobytes())
    header = json.loads(data[8 : 8 + header_len].tobytes())
    body = 8 + header_len
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        start, end = entry["data_offsets"]
        raw = torch.from_numpy(np.array(data[body + start : body + end]))
        out[name] = raw.view(SAFETENSORS_DTYPES[entry["dtype"]]).reshape(entry["shape"])
    return out


def permute_rope(w: torch.Tensor, n_head: int, head_dim: int) -> torch.Tensor:
    """HF half-split RoPE layout -> interleaved pairs."""
    if w.ndim == 2:
        dim = w.shape[-1]
        return (w.reshape(n_head, 2, head_dim // 2, dim).permute(0, 2, 1, 3)
                .reshape(n_head * head_dim, dim))
    return w.reshape(n_head, 2, head_dim // 2).permute(0, 2, 1).reshape(n_head * head_dim)


def load_state_files(checkpoint_dir: Path):
    """All weight files (index-sharded, single-file, or Meta consolidated)
    and the key map that reads them."""
    original = checkpoint_dir / "original"
    meta_files = (
        sorted(f for f in original.iterdir() if re.match(r"^consolidated\.\d{2}\.pth$", f.name))
        if original.is_dir() else []
    )
    if meta_files:
        if len(meta_files) > 1:
            raise ValueError("Merging multiple consolidated.NN.pth shards is not supported.")
        return meta_files, META_WEIGHT_MAP

    index_files = list(checkpoint_dir.glob("*.index.json"))
    if index_files:
        with open(index_files[0]) as f:
            bin_index = json.load(f)
        files = sorted({checkpoint_dir / b for b in bin_index["weight_map"].values()})
    elif (checkpoint_dir / "pytorch_model.bin").exists():
        files = [checkpoint_dir / "pytorch_model.bin"]
    else:
        files = [checkpoint_dir / "model.safetensors"]
    return files, HF_WEIGHT_MAP


def convert_hf_checkpoint(checkpoint_dir: Path, model_name: Optional[str] = None,
                          device=None) -> Path:
    """Write ``<checkpoint_dir>/model.npz`` (unless it exists) and return
    its path. The casts and permutations run on ``device``: the card unless
    the caller asks for the CPU."""
    device = resolve_device(device)
    checkpoint_dir = Path(checkpoint_dir)
    out_path = checkpoint_dir / "model.npz"
    if out_path.exists():
        print(f"Model already exists at {out_path}")
        return out_path

    cfg = ModelConfig.from_name(model_name or checkpoint_dir.name)
    print(f"Model config: {cfg}")

    files, weight_map = load_state_files(checkpoint_dir)
    merged = {}
    for file in files:
        if str(file).endswith(".safetensors"):
            merged.update(read_safetensors(file))
        else:
            merged.update(torch.load(str(file), map_location="cpu", mmap=True,
                                     weights_only=True))

    flat = {}
    for key, value in merged.items():
        # Only the layer index is abstracted: a bare \d+ substitution would
        # also hit the digits in Meta names like feed_forward.w1.
        abstract = re.sub(r"layers\.(\d+)\.", "layers.{}.", key) if "layers" in key else key
        if abstract not in weight_map:
            print(f"  skipping unmapped key {key}")
            continue
        target = weight_map[abstract]
        if target is None:
            continue
        layer_num = re.search(r"\d+", key).group(0) if "layers" in key else None
        arr = torch.as_tensor(value).to(device, torch.float32)
        if isinstance(target, tuple):
            name, kind = target
            if kind == "w" and "wq" in name:
                arr = permute_rope(arr, cfg.n_head, cfg.head_dim)
            elif kind == "w" and "wk" in name:
                arr = permute_rope(arr, cfg.n_kv_head, cfg.head_dim)
            elif kind == "b" and name.endswith("bq"):
                arr = permute_rope(arr, cfg.n_head, cfg.head_dim)
            elif kind == "b" and name.endswith("bk"):
                arr = permute_rope(arr, cfg.n_kv_head, cfg.head_dim)
            if kind in ("w", "w_nopermute"):
                arr = arr.T.contiguous()  # torch [out, in] -> ours [in, out]
            name = name.format(layer_num) if layer_num is not None else name
        else:
            name = target.format(layer_num) if layer_num is not None else target
        # Compact lossless storage: bf16, the checkpoint's source type and the
        # load precision.
        flat[name] = arr.to(torch.bfloat16)

    tied = "output" not in flat
    params = _nest(flat, cfg, tied)

    # Llama-3: copy the tiktoken model next to the checkpoint.
    original = checkpoint_dir / "original"
    if (original / "tokenizer.model").exists() and not (
            checkpoint_dir / "tokenizer.model").exists():
        shutil.copy(original / "tokenizer.model", checkpoint_dir / "tokenizer.model")

    print(f"Saving checkpoint to {out_path}")
    save_params(params, str(out_path))
    return out_path


def _nest(flat, cfg: ModelConfig, tied: bool):
    layers = []
    for i in range(cfg.n_layer):
        attn = {k: flat[f"layers.{i}.attn.{k}"] for k in ("wq", "wk", "wv", "wo")}
        for b in ("bq", "bk", "bv"):
            if f"layers.{i}.attn.{b}" in flat:
                attn[b] = flat[f"layers.{i}.attn.{b}"]
        layers.append({
            "attn": attn,
            "ffn": {k: flat[f"layers.{i}.ffn.{k}"] for k in ("w1", "w2", "w3")},
            "attention_norm": flat[f"layers.{i}.attention_norm"],
            "ffn_norm": flat[f"layers.{i}.ffn_norm"],
        })
    return {
        "tok_embeddings": flat["tok_embeddings"],
        "layers": layers,
        "norm": flat["norm"],
        "output": None if tied else flat["output"],
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Convert a HuggingFace checkpoint to npz.")
    parser.add_argument("--checkpoint_dir", type=Path,
                        default=Path("checkpoints/meta-llama/Meta-Llama-3-8B-Instruct"))
    parser.add_argument("--model_name", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) | cpu")
    args = parser.parse_args(argv)
    convert_hf_checkpoint(args.checkpoint_dir, args.model_name, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
