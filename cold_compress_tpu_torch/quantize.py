"""Weight-quantization CLI of the port: rewrite a checkpoint as int8 or int4.

Counterpart of the repository's ``quantize.py``: reads ``<stem>.npz`` (the
flat key scheme; its parent directory names the architecture) and writes
``<stem>_int8.npz`` or ``<stem>_int4.g<groupsize>.npz`` next to it, with the
same bytes as the JAX package's CLI writes for the same input. It
quantizes on the card unless ``--device cpu`` is given, leaf by leaf:

    python -m cold_compress_tpu_torch.quantize --mode int4 --groupsize 128 \\
        --checkpoint_path ckpt/byte/Meta-Llama-3-8B-Instruct/model.npz
    python -m cold_compress_tpu_torch.quantize --device cpu --mode int8 \\
        --checkpoint_path ckpt/byte/TestKernel/model.npz

``--mode int4-gptq`` is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional, Sequence

from .quantization.weight_quant import quantize_params
from .runtime.engine import load_model, save_params


def quantize(checkpoint_path: Path, mode: str = "int8", groupsize: int = 128,
             model_name: Optional[str] = None, head_bits: Optional[int] = None,
             device=None) -> Path:
    """Quantize one checkpoint and return the path written. The vocab head
    takes ``head_bits`` (default: 4 for int4 modes, else 8)."""
    if mode == "int4-gptq":
        raise ValueError("--mode int4-gptq is not ported yet (ROADMAP: GPTQ)")
    if mode not in ("int8", "int4"):
        raise ValueError(f"Invalid quantization mode {mode} (needs to be one of int8, int4, "
                         "int4-gptq)")
    checkpoint_path = Path(checkpoint_path)
    if head_bits is None:
        head_bits = 4 if mode.startswith("int4") else 8
    t0 = time.time()
    _, params = load_model(checkpoint_path, model_name=model_name, device=device)
    print(f"Loaded model in {time.time() - t0:.02f}s")

    if mode == "int8":
        print("Quantizing model weights for int8 weight-only symmetric per-channel quantization")
        quantized = quantize_params(params, mode="int8", output_mode=f"int{head_bits}")
        new_path = checkpoint_path.parent / f"{checkpoint_path.stem}_int8.npz"
    else:
        print("Quantizing model weights for int4 weight-only affine per-channel groupwise "
              f"quantization (groupsize={groupsize})")
        quantized = quantize_params(params, mode="int4", group_size=groupsize,
                                    output_mode=f"int{head_bits}")
        new_path = checkpoint_path.parent / f"{checkpoint_path.stem}_int4.g{groupsize}.npz"
    del params
    print(f"Writing quantized weights to {new_path}")
    save_params(quantized, new_path)
    print(f"Quantization complete took {time.time() - t0:.02f} seconds")
    return new_path


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Quantize a model checkpoint.")
    parser.add_argument("--checkpoint_path", type=Path,
                        default=Path("checkpoints/meta-llama/Meta-Llama-3-8B-Instruct/model.npz"))
    parser.add_argument("--model_name", type=str, default=None)
    parser.add_argument("--mode", "-q", type=str, default="int8",
                        choices=["int8", "int4", "int4-gptq"])
    parser.add_argument("--groupsize", type=int, default=128)
    parser.add_argument("--head_bits", type=int, default=None, choices=[8, 4],
                        help="Vocab-head weight bits (default: 4 for int4 modes, else 8).")
    parser.add_argument("--calibration_limit", type=int, default=10,
                        help="GPTQ only (not ported yet).")
    parser.add_argument("--calibration_seq_length", type=int, default=512,
                        help="GPTQ only (not ported yet).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) | cpu")
    args = parser.parse_args(argv)
    quantize(args.checkpoint_path, args.mode, args.groupsize, model_name=args.model_name,
             head_bits=args.head_bits, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
