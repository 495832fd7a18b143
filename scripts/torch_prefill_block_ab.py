#!/usr/bin/env python3
"""K4/K6 of this tree at ``q_offset = 0`` against an earlier
``flash_prefill.cu`` that has no query-block form, on one card.

The earlier source's C interface is the whole-prompt one (``flash_fwd(q,
k, v, y, m, 1/l, B, H, KVH, P, scale, stream)``, ``flash_colsum(q, k, m,
1/l, plen, ws, out, B, H, KVH, P, scale, seg_rows, n_seg, mode, obs_len,
n_windows, w0..w3, stream)``). At the main path's shapes (B = 1, 32 / 8
heads, P = 8192, prompt 7928) the script checks that this tree's passes
and its ``flash_prefill_partial``/``flash_profile_partial`` at offset 0
return the earlier kernel's bits (y, each row's statistics, the raw sums
for K4 and for K6 at one and two windows), and times K4 both ways in turns
(earlier, current, current, earlier). Run from the repository root in a
chip call:

    git show <commit>:cold_compress_tpu_torch/csrc/flash_prefill.cu > build/parent/flash_prefill.cu
    python3 scripts/torch_prefill_block_ab.py --earlier build/parent/flash_prefill.cu

It prints one JSON line (and writes it to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402
from cold_compress_tpu_torch.bench import card_line  # noqa: E402
from cold_compress_tpu_torch.ops import _build, prefill_attn  # noqa: E402


def load_earlier(source: str) -> ctypes.CDLL:
    out = os.path.join("build", "prefill_block_ab", "libflash_prefill_earlier.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, source], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(os.path.abspath(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [ptr] * 6 + [i32] * 4 + [ctypes.c_float, ptr]
    lib.flash_colsum.argtypes = [ptr] * 7 + [i32] * 4 + [ctypes.c_float] + [i32] * 9 + [ptr]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--earlier", required=True, help="an earlier flash_prefill.cu")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()
    _build.build_all()
    old = load_earlier(args.earlier)
    dev = torch.device("cuda")
    B, H, KVH, P, D, plen = 1, 32, 8, 8192, 128, 7928
    q, k, v = chip_smoke.partial_inputs(dev, 5, P)
    stream = _build.stream_ptr(dev)
    scale = math.log2(math.e) / math.sqrt(D)
    plen_t = torch.full((B,), plen, dtype=torch.int32, device=dev)
    seg_rows, n_seg = prefill_attn.colsum_segments(P, H // KVH)
    y = torch.empty_like(q)
    m = torch.empty((B, KVH, P * (H // KVH)), device=dev)
    il = torch.empty_like(m)

    def old_pass1():
        status = old.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(),
                               m.data_ptr(), il.data_ptr(), B, H, KVH, P, scale, stream)
        assert status == 0, status

    def old_pass2(mode, windows):
        n_acc = 2 if mode == 0 else 1 + len(windows)
        ws = torch.empty((n_acc, n_seg, B, KVH, P), device=dev)
        out = torch.empty((n_acc, B, KVH, P), device=dev)
        wl = list(windows) + [1] * (prefill_attn.MAX_WINDOWS - len(windows))
        status = old.flash_colsum(q.data_ptr(), k.data_ptr(), m.data_ptr(), il.data_ptr(),
                                  plen_t.data_ptr(), ws.data_ptr(), out.data_ptr(), B, H, KVH,
                                  P, scale, seg_rows, n_seg, mode, 16, len(windows), *wl, stream)
        assert status == 0, status
        return out

    old_pass1()
    y1, m1, il1 = prefill_attn.flash_pass1(q, k, v)
    row = {"pass1_bit_equal": torch.equal(y, y1) and torch.equal(m, m1) and torch.equal(il, il1)}
    for mode, windows in ((0, ()), (1, (2457,)), (1, (819, 2457))):
        want = old_pass2(mode, windows)
        if mode == 0:
            got = prefill_attn.flash_prefill_partial(q, k, v, plen)
            same = torch.equal(got[1], want[0]) and torch.equal(got[2], want[1])
        else:
            got = prefill_attn.flash_profile_partial(q, k, v, plen, windows)
            same = torch.equal(got[1], want[0]) and torch.equal(got[2], want[1:])
        row[f"k{4 if mode == 0 else 6}{list(windows)}_bit_equal"] = same and torch.equal(got[0], y)

    def old_k4(i=0):
        old_pass1()
        old_pass2(0, ())

    def new_k4(i=0):
        prefill_attn.flash_prefill_partial(q, k, v, plen)

    a1 = chip_smoke.time_ms(old_k4, 5, 1)
    b1 = chip_smoke.time_ms(new_k4, 5, 1)
    b2 = chip_smoke.time_ms(new_k4, 5, 1)
    a2 = chip_smoke.time_ms(old_k4, 5, 1)
    row.update(earlier_k4_ms=(a1 + a2) / 2, k4_ms=(b1 + b2) / 2, card=card_line())
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f)
    return 0 if all(v for key, v in row.items() if key.endswith("bit_equal")) else 1


if __name__ == "__main__":
    sys.exit(main())
