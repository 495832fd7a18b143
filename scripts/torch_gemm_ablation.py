#!/usr/bin/env python3
"""Where K8 (``csrc/w4a8_gemm.cu``) and K9 (``csrc/w8a8_gemv.cu``) spend their
time: each kernel built again with one part of its work cut out, timed
beside the unchanged kernel on one card.

    python3 scripts/torch_gemm_ablation.py

Each variant is a copy of the source with a textual substitution, built by
``nvcc`` (the port's flags) into ``build/ablation/<variant>/``; a variant
computes wrong results and serves only as a timing. K8 at L = 8192, group
size 128 (its instance with two accumulator sets and the zero term on the
tensor cores), the 8B projections wqkv, w13 and w2:

- ``noflush``: no f32 flush of the integer group dots;
- ``nozero``: no zero-term wgmma (the bf16 products of the group sums);
- ``nomma``: no int8 wgmma (the weights are still unpacked into registers);
- ``nomma_noflush``: neither: the copies, the unpacking and the barriers.

K9 at L = 1, the four int8 layer projections:

- ``noprologue``: no activation quantization (x is still copied in);
- ``nostream``: no weight pieces copied or multiplied: the launch, the
  prologue and the closing reduction.

Prints one JSON row per shape with every variant's ms, then the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (time_ms, copies_for)
from cold_compress_tpu_torch.bench import card_line  # noqa: E402
from cold_compress_tpu_torch.ops import _build, qmm  # noqa: E402

CSRC = ROOT / "cold_compress_tpu_torch" / "csrc"

_NOFLUSH = ("flush_int(acc, DP, psz0, psz1);", "(void)psz0;")
_NOZERO = ("zero_term(acc, sz, r0, r1, OUT, ng, (G), tig,",
           "if (0) zero_term(acc, sz, r0, r1, OUT, ng, (G), tig,")
_NOMMA = ("wgmma_s8(DC, a, desc + 2 * sub, sub == 0 ? 0 : 1);", "DC[sub] += a[0] ^ a[3];")
GEMM_VARIANTS = {"base": [], "noflush": [_NOFLUSH], "nozero": [_NOZERO], "nomma": [_NOMMA],
                 "nomma_noflush": [_NOMMA, _NOFLUSH]}
GEMV_VARIANTS = {
    "base": [],
    "noprologue": [("quantize_rows_int8<kWarps>(xs, IN, 0, nrows, xq, sx, red);",
                    "if (tid < ROWS) sx[tid] = 1.f;\n    __syncthreads();")],
    "nostream": [("acc[j * ROWS] = dot16(xa[k], wv[k], acc[j * ROWS]);",
                  "acc[j * ROWS] += xa[k].x;"),
                 ("const uint32_t bytes = col < OUT ? min(kPiece, IN - ip * kPiece) : 0;",
                  "const uint32_t bytes = 0;")],
}


def build(source: str, variants: dict):
    """Each variant of ``csrc/<source>.cu`` as a loaded shared library."""
    text = (CSRC / f"{source}.cu").read_text()
    procs, paths = {}, {}
    for name, subs in variants.items():
        t = text
        for a, b in subs:
            if a not in t:
                raise RuntimeError(f"{source}: variant {name} does not match the source")
            t = t.replace(a, b)
        out = ROOT / "build" / "ablation" / f"{source}.{name}"
        out.mkdir(parents=True, exist_ok=True)
        (out / "k.cu").write_text(t)
        paths[name] = out / "k.so"
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(paths[name]),
             str(out / "k.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {source}.{name}:\n{log}")
    return {name: ctypes.CDLL(str(p)) for name, p in paths.items()}


def gemm_rows(dev, libs):
    gs, L = 128, 8192
    for IN, OUT in ((4096, 6144), (4096, 28672), (14336, 4096)):
        gen = torch.Generator(device=dev).manual_seed(IN + OUT)
        ng = IN // gs
        wg = torch.randint(0, 256, (OUT, IN // 2), dtype=torch.uint8, device=dev, generator=gen)
        sc = torch.rand((OUT, ng), device=dev, generator=gen) * 3e-3 + 1e-3
        z = (torch.rand((OUT, ng), device=dev, generator=gen) - 0.5) * 2e-2
        sz = torch.stack([sc, z], -1).to(torch.bfloat16).contiguous()
        x = torch.randn((L, IN), device=dev, generator=gen).to(torch.bfloat16)
        xq, sx, xs, xsb = qmm.w4a8_gemm_quantize(x, gs)
        y = torch.empty((L, OUT), dtype=torch.float32, device=dev)
        ctas, group = qmm.gemm_schedule(L, OUT, qmm.sm_count(dev))
        Lp = -(-L // qmm.GEMM_TILE_ROWS) * qmm.GEMM_TILE_ROWS
        row = dict(kernel="w4a8_gemm", L=L, IN=IN, OUT=OUT, gs=gs)
        for name, lib in libs.items():
            fn = lib.w4a8_gemm
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def run(i, fn=fn, name=name):
                _build.check(fn(xq.data_ptr(), sx.data_ptr(), qmm._ptr(xs), qmm._ptr(xsb),
                                wg.data_ptr(), sz.data_ptr(), y.data_ptr(), L, IN, OUT, gs, Lp,
                                ctas, group, _build.stream_ptr(dev)), name)
            row[f"{name}_ms"] = chip_smoke.time_ms(run, 5, 1)
        print(json.dumps(row), flush=True)
        del wg, sz, x, xq, xs, xsb, y


def gemv_rows(dev, libs):
    for IN, OUT in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
        gen = torch.Generator(device=dev).manual_seed(IN + OUT)
        n = chip_smoke.copies_for(IN * OUT)
        layers = []
        for _ in range(n):
            w = torch.randint(-127, 128, (IN, OUT), dtype=torch.int8, device=dev, generator=gen)
            layers.append(qmm.int8_to_gemv(w, torch.rand((OUT,), device=dev, generator=gen)))
            del w
        x = torch.randn((1, IN), device=dev, generator=gen).to(torch.bfloat16)
        y = torch.empty((1, OUT), dtype=torch.float32, device=dev)
        cols = qmm.w8a8_partition(1, OUT, qmm.sm_count(dev))
        row = dict(kernel="w8a8_gemv", L=1, IN=IN, OUT=OUT, cols=cols,
                   launch_floor_ms=chip_smoke.launch_floor_ms())
        for name, lib in libs.items():
            fn = lib.w8a8_gemv
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def run(i, fn=fn, name=name):
                wt, st = layers[i % n]
                _build.check(fn(x.data_ptr(), wt.data_ptr(), st.data_ptr(), y.data_ptr(), 1, IN,
                                OUT, cols, _build.stream_ptr(dev)), name)
            row[f"{name}_ms"] = chip_smoke.time_ms(run, 50)
        print(json.dumps(row), flush=True)
        del layers


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gemm_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = "cuda"
    card = card_line()
    _build.build_all()
    gemm_libs = build("w4a8_gemm", GEMM_VARIANTS)
    gemv_libs = build("w8a8_gemv", GEMV_VARIANTS)
    gemm_rows(dev, gemm_libs)
    gemv_rows(dev, gemv_libs)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
