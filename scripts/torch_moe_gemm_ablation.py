#!/usr/bin/env python3
"""Where the experts' prefill GEMM (``csrc/moe_gemm.cu``) spends its time:
the kernel built again with one part of its work cut out, timed beside the
unchanged kernel on one card, at Mellum2's widths (64 experts of 2304 x
896, top 8) over the benchmark cell's four lanes of 8064 rows.

    python3 scripts/torch_moe_gemm_ablation.py

Each variant is a copy of the source with a textual substitution, built by
``nvcc`` (the port's flags) into ``build/ablation/``
(``scripts/torch_gemm_ablation.py::build``); a variant computes wrong
results and serves only as a timing:

- ``nodequant``: the packed words go to the wgmmas as they are (no int4 ->
  bf16 conversion; the shared-memory reads stay);
- ``nogather``: no token row copied in (the barriers still complete);
- ``noepilogue``: no h or y row written;
- ``nomma``: no wgmma (the weights are still converted);
- ``skeleton``: neither the gather nor the wgmmas; ``mmaonly``: neither the
  gather nor the conversion;
- ``cheapsilu``: SwiGLU's silu taken as the identity (no exp, no division).

Beside them, ``cublas_loop_ms``: the same rows through cuBLAS, a matmul per
expert over its rows padded to 256 and its weights dequantized beforehand.

Prints one JSON row per launch (gate/up, down) with every variant's ms,
then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402  (time_ms, m2_experts)
from cold_compress_tpu_torch.bench import card_line  # noqa: E402
from cold_compress_tpu_torch.ops import _build, moe, qmm  # noqa: E402
from torch_gemm_ablation import build  # noqa: E402

VARIANTS = {
    "base": [],
    "nodequant": [("return pack_bf16(__fmaf_rn(q0, s, z), __fmaf_rn(q1, s, z));",
                   "(void)q0; (void)q1; return word;")],
    "nogather": [("cp_async16(st + r * 128 + ((c ^ (r & 7)) << 4), g, src < 0 ? 0 : 16);",
                  "(void)g;"),
                 ("mbar_expect(bar, kWBytes + (SWIGLU ? 0 : kXBytes));",
                  "mbar_expect(bar, kWBytes);"),
                 ("if (!SWIGLU) tma_load_2d(st, &tm_x, kt * kBK, first, bar);", "")],
    "noepilogue": [("if (t < rows) {", "if (t < rows && first < 0) {")],
    "nomma": [("wgmma_n256(acc, CUR[s], desc + 2 * s, ((KT) | s) != 0);",
               "acc[s] += __uint_as_float(CUR[s][0] ^ CUR[s][3]);")],
    "skeleton": [],  # nogather + nomma, filled in below
    "mmaonly": [],  # nogather + nodequant
    "cheapsilu": [("return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));", "return v;")],
}

VARIANTS["skeleton"] = VARIANTS["nogather"] + VARIANTS["nomma"]
VARIANTS["mmaonly"] = VARIANTS["nogather"] + VARIANTS["nodequant"]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_moe_gemm_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    _build.build_all()
    libs = build("moe_gemm", VARIANTS)
    M2 = chip_smoke.M2
    D, F, E, K = M2["D"], M2["F"], M2["E"], M2["K"]
    gen = torch.Generator(device=dev).manual_seed(5)
    mw = chip_smoke.m2_experts(dev, gen)
    N = 4 * 8064
    x = torch.randn((N, D), device=dev, generator=gen).to(torch.bfloat16)
    ids = torch.topk(torch.rand((N, E), device=dev, generator=gen), K, dim=-1).indices
    sched = moe.dispatch(ids, E)
    h = torch.zeros((N * K, F), dtype=torch.bfloat16, device=dev)
    y = torch.empty((N * K, D), dtype=torch.bfloat16, device=dev)
    slots = sched.tiles.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for part, args in (("w13", (x, sched.src, mw.w13, mw.sz13, h, D, 2 * F, True)),
                       ("w2", (h, sched.pair, mw.w2, mw.sz2, y, F, D, False))):
        a, rowmap, w, sz, out, IN, OUT, swiglu = args
        row = dict(launch=part, N=N, IN=IN, OUT=OUT,
                   tflop=2 * N * K * IN * OUT / 1e12)
        for name, lib in libs.items():
            fn = lib.moe_gemm
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                           + [ctypes.c_int] * 7 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            ctas = min(sms, slots * (OUT // moe.ITEM_COLS))

            def run(i, fn=fn, name=name):
                _build.check(fn(a.data_ptr(), rowmap.data_ptr(), sched.tiles.data_ptr(), slots,
                                w.data_ptr(), sz.data_ptr(), out.data_ptr(), a.shape[0], E, IN,
                                OUT, 128,
                                int(swiglu), ctas, _build.stream_ptr(dev)), name)
            row[f"{name}_ms"] = chip_smoke.time_ms(run, 5, 1)
        # cuBLAS over the same rows, each expert's padded to 256, weights
        # dequantized beforehand (the layer's per-expert loop before).
        counts = torch.bincount(ids.reshape(-1), minlength=E).tolist()
        off = [0]
        for c in counts:
            off.append(off[-1] + -(-c // 256) * 256)
        rows_in = torch.zeros((off[-1], IN), dtype=torch.bfloat16, device=dev)
        wd = qmm.dequantize_gemv(w, sz, 128)
        res = torch.empty((off[-1], OUT), dtype=torch.bfloat16, device=dev)

        def loop(i):
            for e in range(E):
                if off[e + 1] > off[e]:
                    torch.matmul(rows_in[off[e]:off[e + 1]], wd[e], out=res[off[e]:off[e + 1]])
        row["cublas_loop_ms"] = chip_smoke.time_ms(loop, 5, 1)
        del rows_in, wd, res
        print(json.dumps(row), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
