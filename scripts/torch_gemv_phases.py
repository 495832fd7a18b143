#!/usr/bin/env python3
"""Where one launch of the port's W4A8 decode matmul (K1, csrc/w4a8_gemv.cu)
spends its time, phase by phase, on one card.

    python3 scripts/torch_gemv_phases.py

Builds the kernel with ``-DGEMV_PHASES`` into ``build/phases/``: thread 0 of
every CTA then stamps ``%globaltimer`` at the ends of its phases (the
source's ``GEMV_STAMP``): start, the first weight copies issued, the row's
absmax, the int8 activations, the weight stream, the end (the last tile's
columns reduced and stored). At the 8B shapes (L = 1, the tile width that
``gemv_partition`` takes) it launches the kernel after the same kernel (back
to back, as ``chip_smoke.time_ms`` times it) and after a few small PyTorch
kernels (an RMS norm, as in a decode step, where the kernel's instructions
are no longer cached), and prints each phase's mean over the CTAs and the
launch's span (first CTA start to last CTA end), mean of five launches, as
JSON rows; also in ``chiprun_out/gemv_phases.json``. The timer ticks every
0.256 us or so: read the means, not single stamps.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (copies_for, the card line)
from cold_compress_tpu_torch.bench import card_line  # noqa: E402
from cold_compress_tpu_torch.ops import _build, qmm  # noqa: E402

PHASES = ("issue", "absmax", "quantize", "stream", "store")
SHAPES = [("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w13", 4096, 28672), ("w2", 14336, 4096),
          ("head", 4096, 128256), ("k10.wk_wv", 4096, 1024)]


def build():
    out = ROOT / "build" / "phases"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libw4a8_gemv_phases.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DGEMV_PHASES", "-o", str(so),
           str(_build.CSRC / "w4a8_gemv.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError("nvcc failed:\n" + done.stdout + done.stderr)
    lib = ctypes.CDLL(str(so))
    lib.w4a8_gemv.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.w4a8_gemv.restype = ctypes.c_int
    lib.w4a8_gemv_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.w4a8_gemv_stamps.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gemv_phases: no CUDA device", file=sys.stderr)
        return 2
    dev, gs = "cuda", 128
    card = card_line()
    lib = build()
    h = torch.randn(1, 4096, device=dev).to(torch.bfloat16)

    def norm():
        hf = h.float()
        return (hf * torch.rsqrt(hf.pow(2).mean(-1, keepdim=True) + 1e-5)).to(torch.bfloat16)

    rows = []
    for label, IN, OUT in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(IN + OUT)
        ng = IN // gs
        n = chip_smoke.copies_for(IN * OUT // 2)
        ws = [torch.randint(0, 256, (OUT, IN // 2), dtype=torch.uint8, device=dev, generator=gen)
              for _ in range(n)]
        szs = [torch.stack([torch.rand((OUT, ng), device=dev, generator=gen) * 3e-3 + 1e-3,
                            (torch.rand((OUT, ng), device=dev, generator=gen) - 0.5) * 2e-2],
                           -1).to(torch.bfloat16).contiguous() for _ in range(n)]
        x = torch.randn((1, IN), device=dev, generator=gen).to(torch.bfloat16)
        cols = qmm.gemv_partition(1, OUT, qmm.sm_count(dev))
        ctas = min(-(-OUT // cols), qmm.sm_count(dev))  # one CTA per SM at most

        def launch(i):
            y = torch.empty((1, OUT), dtype=torch.float32, device=dev)
            _build.check(lib.w4a8_gemv(x.data_ptr(), ws[i % n].data_ptr(), szs[i % n].data_ptr(),
                                       y.data_ptr(), 1, IN, OUT, gs, cols,
                                       _build.stream_ptr(dev)), "w4a8_gemv (phases)")

        for mode in ("after_same", "after_norm"):
            phases, spans = [], []
            for rep in range(5):
                torch.cuda.synchronize()
                torch.cuda._sleep(1_000_000)
                if mode == "after_same":
                    launch(rep + 1)
                else:
                    norm()
                    norm()
                launch(rep)
                torch.cuda.synchronize()
                t = np.zeros((ctas, 8), dtype=np.uint64)
                _build.check(lib.w4a8_gemv_stamps(t.ctypes.data, ctas), "stamps")
                t = t[:, :6].astype(np.float64)
                t -= t[:, 0].min()
                phases.append(np.diff(t, axis=1).mean(0) / 1e3)
                spans.append(t[:, 5].max() / 1e3)
            row = dict(shape=label, IN=IN, OUT=OUT, cols=cols, ctas=ctas, mode=mode,
                       span_us=float(np.mean(spans)),
                       **{f"{p}_us": float(v) for p, v in zip(PHASES, np.mean(phases, 0))})
            print(json.dumps(row), flush=True)
            rows.append(row)
        del ws, szs
    out = ROOT / "chiprun_out"
    os.makedirs(out, exist_ok=True)
    (out / "gemv_phases.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
