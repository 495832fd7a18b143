#!/usr/bin/env python3
"""Kernels of the PyTorch/CUDA port against an earlier version of their CUDA
sources, on one card, in one process, in turns (earlier, current, current,
earlier).

    python3 scripts/torch_kernel_ab.py --earlier <csrc directory> [--kernels gemv,evict]

``--earlier`` names an earlier ``csrc`` directory; the sources of the
chosen kernel groups are built from it by ``nvcc`` into ``build/ab/``. At
the 8B shapes it prints one JSON row per case, and writes them to
``chiprun_out/kernel_ab.json`` with the card's name and power limit:

- ``gemv`` (``w4a8_gemv.cu``; the earlier one with the C interface
  ``w4a8_gemv(x, w, sz, y, L, IN, OUT, gs, stream)``): K1's four layer
  projections, K2's int4 head and K10's four unfused rowpack shapes at
  L = 1, earlier and current, each also launched after an RMS norm's few
  small kernels (as inside a decode step; the norm's own time subtracted),
  the largest difference between their outputs, and the current kernel at
  every column tile beside the one ``gemv_partition`` takes;
- ``evict`` (``hh_evict.cu``, same C interface): K7 at the main path's
  8 x 2048 and at C = 2047, B = 2;
- ``gemm`` (``w4a8_gemm.cu``; the earlier one with the one-call C interface
  ``w4a8_gemm(x, w, sz, xq, sx, xs, y, L, IN, OUT, gs, stream)``): K8's four
  layer projections at L = 8192, group size 128, earlier and current, the
  current activation quantization alone, TOP/s, and wqkv at group sizes 32,
  64 and 256;
- ``w8a8`` (``w8a8_gemv.cu``; the earlier one with the C interface
  ``w8a8_gemv(x, w, s, y, L, IN, OUT, stream)``): K9's head and four layer
  projections at L = 1 and 5, earlier and current, back to back and after
  an RMS norm's small kernels, bit-equality between the two, and the
  current kernel at every column tile;
- ``decode`` and ``prefill`` (``decode_attn.cu``, ``flash_prefill.cu``; the
  earlier ones with the C interfaces of the three-launch decode kernel and
  the first flash prefill: ``decode_attention`` with a
  ``decode_attention_workspace``; ``flash_prefill_summary`` and
  ``flash_profile``): decode attention at C = 2048 and 32768 for the cache
  precisions the paths run, beside ``scaled_dot_product_attention`` on the
  bf16 cache, and the current kernel at clusters of 8 and 16 CTAs at
  C = 32768; K4 at P = 8192 (prompt 7928), each pass alone and both, and K6
  at one and two windows.

Every group also reports the launch floor (``chip_smoke.launch_floor_ms``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (time_ms, bound, copies_for, the decode inputs)
from cold_compress_tpu_torch.bench import card_line  # noqa: E402
from cold_compress_tpu_torch.ops import _build, decode_attn, evict, prefill_attn, qmm  # noqa: E402

#: The earlier source each kernel group needs.
SOURCES = {"gemv": "w4a8_gemv", "evict": "hh_evict", "decode": "decode_attn",
           "prefill": "flash_prefill", "gemm": "w4a8_gemm", "w8a8": "w8a8_gemv"}


def build_earlier(csrc: Path, names):
    """The earlier sources ``names`` as shared libraries."""
    h = hashlib.sha256()
    for name in names:
        h.update((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.read_bytes())
    out = ROOT / "build" / "ab" / h.hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, {}
    for name in names:
        so = out / f"lib{name}.so"
        if not so.exists():
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
                   str(csrc / f"{name}.cu")]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)
        libs[name] = so
    for name, p in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for the earlier {name}:\n{text}")
    return {n: ctypes.CDLL(str(p)) for n, p in libs.items()}


def earlier_decode(lib):
    fn, ws = lib.decode_attention, lib.decode_attention_workspace
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws.argtypes = [ctypes.c_int] * 4
    ws.restype = ctypes.c_size_t

    def run(q, kc, vc, ks, kz, vs, vz, mask, bits, need_attn):
        B, H, _, D = q.shape
        KVH, C = kc.shape[1], kc.shape[2]
        G = H // KVH
        out = torch.empty((B, H, 1, D), dtype=torch.float32, device=q.device)
        pooled = torch.empty((B, KVH, 1, C), dtype=torch.float32, device=q.device)
        work = torch.empty(ws(B, KVH, C, G), dtype=torch.float32, device=q.device)

        def ptr(t):
            return None if t is None else t.data_ptr()

        _build.check(fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ptr(ks), ptr(kz), ptr(vs),
                        ptr(vz), mask.data_ptr(), out.data_ptr(), pooled.data_ptr(),
                        work.data_ptr(), B, KVH, C, G, bits, int(need_attn), 1 / math.sqrt(D),
                        _build.stream_ptr(q.device)), "earlier decode_attention")
        return out.to(q.dtype), pooled
    return run


def earlier_prefill(lib):
    k4, k6 = lib.flash_prefill_summary, lib.flash_profile
    k4.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    k6.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    k4.restype = k6.restype = ctypes.c_int

    def bufs(q, k, n_acc):
        B, H, P, D = q.shape
        KVH = k.shape[1]
        dev = q.device
        y = torch.empty_like(q)
        ml = torch.empty((2, B, KVH, P * (H // KVH)), dtype=torch.float32, device=dev)
        acc = torch.empty((n_acc, B, KVH, P), dtype=torch.float32, device=dev)
        return y, ml, acc

    def summary(q, k, v, plen, need_summary=True):
        B, H, P, D = q.shape
        y, ml, acc = bufs(q, k, 2)
        _build.check(k4(q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), ml[0].data_ptr(),
                        ml[1].data_ptr(), plen.data_ptr(), acc[0].data_ptr(), acc[1].data_ptr(),
                        B, H, k.shape[1], P, 1 / math.sqrt(D), 16, int(need_summary),
                        _build.stream_ptr(q.device)), "earlier flash_prefill_summary")
        return y, acc

    def profile(q, k, v, plen, windows):
        B, H, P, D = q.shape
        y, ml, acc = bufs(q, k, 1 + len(windows))
        wl = list(windows) + [1] * (4 - len(windows))
        _build.check(k6(q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), ml[0].data_ptr(),
                        ml[1].data_ptr(), plen.data_ptr(), acc[0].data_ptr(), acc[1].data_ptr(),
                        B, H, k.shape[1], P, 1 / math.sqrt(D), len(windows), *wl,
                        _build.stream_ptr(q.device)), "earlier flash_profile")
        return y, acc
    return summary, profile


def earlier_gemv(lib, with_cols: bool):
    """The earlier K1: the first C interface, or the later one with the
    column tile (``with_cols``; the tile ``gemv_partition`` takes)."""
    fn = lib.w4a8_gemv
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (5 if with_cols else 4) + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, wg, sz, gs):
        L, IN = x.shape
        OUT = wg.shape[0]
        y = torch.empty((L, OUT), dtype=torch.float32, device=x.device)
        cols = [qmm.gemv_partition(L, OUT, qmm.sm_count(x.device))] if with_cols else []
        _build.check(fn(x.data_ptr(), wg.data_ptr(), sz.data_ptr(), y.data_ptr(), L, IN, OUT, gs,
                        *cols, _build.stream_ptr(x.device)), "earlier w4a8_gemv")
        return y
    return run


def earlier_evict(lib):
    fn = lib.hh_evict
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(num, denom, pos, ipos, global_tokens, recent_window):
        B, H, C = pos.shape
        idx = torch.empty((B, H), dtype=torch.int32, device=num.device)
        _build.check(fn(num.data_ptr(), denom.data_ptr(), pos.data_ptr(), ipos.data_ptr(),
                        idx.data_ptr(), B, H, C, global_tokens, recent_window,
                        _build.stream_ptr(num.device)), "earlier hh_evict")
        return idx
    return run


#: (kernel, IN, OUT) at L = 1: K1's four layer projections, K2's int4 head
#: and K10's unfused rowpack projections of Llama-3-8B.
GEMV_CASES = [
    ("w4a8_gemv.wqkv", 4096, 6144),
    ("w4a8_gemv.wo", 4096, 4096),
    ("w4a8_gemv.w13", 4096, 28672),
    ("w4a8_gemv.w2", 14336, 4096),
    ("w4a8_gemv.head", 4096, 128256),
    ("k10.wq", 4096, 4096),
    ("k10.wk_wv", 4096, 1024),
    ("k10.w1_w3", 4096, 14336),
    ("k10.w2", 14336, 4096),
]


def gemv_ab(dev, earlier, rows):
    gs = 128
    small = chip_smoke.small_kernels
    small_ms = chip_smoke.time_ms(small, 100)
    for name, IN, OUT in GEMV_CASES:
        gen = torch.Generator(device=dev).manual_seed(IN + OUT)
        ng = IN // gs
        nbytes = IN * OUT // 2 + OUT * ng * 4 + 2 * IN + 4 * OUT
        n = chip_smoke.copies_for(nbytes)
        ws = [torch.randint(0, 256, (OUT, IN // 2), dtype=torch.uint8, device=dev,
                            generator=gen) for _ in range(n)]
        szs = []
        for _ in range(n):
            sc = torch.rand((OUT, ng), device=dev, generator=gen) * 3e-3 + 1e-3
            z = (torch.rand((OUT, ng), device=dev, generator=gen) - 0.5) * 2e-2
            szs.append(torch.stack([sc, z], -1).to(torch.bfloat16).contiguous())
        x = torch.randn((1, IN), device=dev, generator=gen).to(torch.bfloat16)
        y_old = earlier(x, ws[0], szs[0], gs)
        y_new = qmm.w4a8_gemv(x, ws[0], szs[0], gs, counter="w4a8_gemv.wo")
        ref = qmm.w4a8_gemv_plain(x, ws[0], szs[0], gs)
        torch.cuda.synchronize()
        tol = 1e-4 * float(ref.abs().max()) + 1e-6
        old, new = turns(lambda i: earlier(x, ws[i % n], szs[i % n], gs),
                         lambda i: qmm.w4a8_gemv(x, ws[i % n], szs[i % n], gs,
                                                 counter="w4a8_gemv.wo"), 50, 2)
        old_s, new_s = turns(lambda i: (earlier(x, ws[i % n], szs[i % n], gs), small(i)),
                             lambda i: (qmm.w4a8_gemv(x, ws[i % n], szs[i % n], gs,
                                                      counter="w4a8_gemv.wo"), small(i)), 50, 2)
        cols = qmm.gemv_partition(1, OUT, qmm.sm_count(dev))
        row = dict(kernel=name, IN=IN, OUT=OUT, earlier_ms=old, ms=new,
                   earlier_after_small_ms=old_s - small_ms, after_small_ms=new_s - small_ms,
                   bound_ms=chip_smoke.bound(nbytes, 2 * IN * OUT, "int8")[0],
                   cols=cols, max_abs_diff_vs_earlier=chip_smoke.max_err(y_old, y_new),
                   max_abs_err_vs_plain=chip_smoke.max_err(y_new, ref), tol=tol)
        if name.startswith("w4a8_gemv.") or name == "k10.wk_wv":
            row["cols_ms"] = {
                c: chip_smoke.time_ms(lambda i: qmm.w4a8_gemv(
                    x, ws[i % n], szs[i % n], gs, counter="w4a8_gemv.wo", cols=c), 50, 2)
                for c in qmm.GEMV_COLS}
        rows.append(row)
        del ws, szs


def evict_ab(dev, earlier, rows):
    g_tok, recent = 4, 10
    for B, H, C in ((1, 8, 2048), (2, 8, 2047)):
        gen = torch.Generator(device=dev).manual_seed(4 + C)
        nbytes = 3 * 4 * B * H * C + 4 * B + 4 * B * H + 2 * 4 * B * H
        n = chip_smoke.copies_for(nbytes)
        cases = []
        for _ in range(n):
            num = torch.randint(1, 64, (B, H, C), device=dev, generator=gen).float() / 4
            denom = torch.randint(0, 9, (B, H, C), device=dev, generator=gen, dtype=torch.int32)
            pos = torch.stack([torch.randperm(C, device=dev, generator=gen)
                               for _ in range(B * H)]).reshape(B, H, C).to(torch.int32)
            cases.append((num, denom, pos))
        ipos = torch.full((B, 1, 1), C + 3, dtype=torch.int32, device=dev)
        ipos_flat = ipos.reshape(-1).contiguous()
        a = [t.clone() for t in cases[0]]
        b = [t.clone() for t in cases[0]]
        same = torch.equal(earlier(a[0], a[1], a[2], ipos_flat, g_tok, recent),
                           evict.hh_evict(b[0], b[1], b[2], ipos, global_tokens=g_tok,
                                          recent_window=recent))
        old, new = turns(lambda i: earlier(*cases[i % n], ipos_flat, g_tok, recent),
                         lambda i: evict.hh_evict(*cases[i % n], ipos, global_tokens=g_tok,
                                                  recent_window=recent), 200, 2)
        rows.append(dict(kernel="hh_evict", B=B, H=H, C=C, earlier_ms=old, ms=new,
                         bound_ms=chip_smoke.bound(nbytes, 4 * B * H * C, "bf16")[0],
                         same_idx_as_earlier=same))


def earlier_gemm(lib):
    fn = lib.w4a8_gemm
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, wg, sz, gs):
        L, IN = x.shape
        OUT = wg.shape[0]
        dev = x.device
        xq = torch.empty((L, IN), dtype=torch.int8, device=dev)
        sx = torch.empty((L,), dtype=torch.float32, device=dev)
        xs = torch.empty((L, IN // gs), dtype=torch.int32, device=dev)
        y = torch.empty((L, OUT), dtype=torch.float32, device=dev)
        _build.check(fn(x.data_ptr(), wg.data_ptr(), sz.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                        xs.data_ptr(), y.data_ptr(), L, IN, OUT, gs,
                        _build.stream_ptr(dev)), "earlier w4a8_gemm")
        return y
    return run


def earlier_w8a8(lib):
    fn = lib.w8a8_gemv
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, wt, s):
        L, IN = x.shape
        OUT = wt.shape[0]
        y = torch.empty((L, OUT), dtype=torch.float32, device=x.device)
        _build.check(fn(x.data_ptr(), wt.data_ptr(), s.data_ptr(), y.data_ptr(), L, IN, OUT,
                        _build.stream_ptr(x.device)), "earlier w8a8_gemv")
        return y
    return run


#: K8's four 8B layer projections (IN, OUT) at a prefill of L = 8192.
GEMM_CASES = [("w4a8_gemm.wqkv", 4096, 6144), ("w4a8_gemm.wo", 4096, 4096),
              ("w4a8_gemm.w13", 4096, 28672), ("w4a8_gemm.w2", 14336, 4096)]


def gemm_ab(dev, earlier, rows):
    """K8 at L = 8192, group size 128, earlier and current in turns; the
    current kernel's activation quantization alone; and wqkv at the other
    group sizes each instance takes (32, 64, 256)."""
    L = 8192
    for name, IN, OUT in GEMM_CASES:
        gen = torch.Generator(device=dev).manual_seed(IN + OUT)
        for gs in (128, 32, 64, 256) if name.endswith("wqkv") else (128,):
            ng = IN // gs
            wg = torch.randint(0, 256, (OUT, IN // 2), dtype=torch.uint8, device=dev,
                               generator=gen)
            sc = torch.rand((OUT, ng), device=dev, generator=gen) * 3e-3 + 1e-3
            z = (torch.rand((OUT, ng), device=dev, generator=gen) - 0.5) * 2e-2
            sz = torch.stack([sc, z], -1).to(torch.bfloat16).contiguous()
            x = torch.randn((L, IN), device=dev, generator=gen).to(torch.bfloat16)
            y_old = earlier(x, wg, sz, gs)
            y_new = qmm.w4a8_gemm(x, wg, sz, gs, counter="w4a8_gemm.wo")
            ref = qmm.w4a8_gemv_plain(x, wg, sz, gs)
            torch.cuda.synchronize()
            old, new = turns(lambda i: earlier(x, wg, sz, gs),
                             lambda i: qmm.w4a8_gemm(x, wg, sz, gs, counter="w4a8_gemm.wo"), 5)
            nops = 2 * L * IN * OUT
            nbytes = IN * OUT // 2 + OUT * ng * 4 + 2 * L * IN + 4 * L * OUT
            rows.append(dict(
                kernel=name, L=L, IN=IN, OUT=OUT, gs=gs, earlier_ms=old, ms=new,
                quant_ms=chip_smoke.time_ms(lambda i: qmm.w4a8_gemm_quantize(x, gs), 5, 1),
                bound_ms=chip_smoke.bound(nbytes, nops, "int8")[0], tops=nops / new / 1e9,
                earlier_tops=nops / old / 1e9,
                max_abs_diff_vs_earlier=chip_smoke.max_err(y_old, y_new),
                max_abs_err_vs_plain=chip_smoke.max_err(y_new, ref),
                tol=1e-4 * float(ref.abs().max()) + 1e-6))
            del wg, sz, x, y_old, y_new, ref


#: K9's shapes (IN, OUT): the int8 head and the four fused layer projections.
W8A8_CASES = [("w8a8_gemv.head", 4096, 128256), ("w8a8_gemv.wqkv", 4096, 6144),
              ("w8a8_gemv.wo", 4096, 4096), ("w8a8_gemv.w13", 4096, 28672),
              ("w8a8_gemv.w2", 14336, 4096)]


def w8a8_ab(dev, earlier, rows):
    """K9 at one row and five, earlier and current in turns, back to back
    and after an RMS norm's small kernels (their time subtracted), and the
    current kernel at every column tile."""
    small = chip_smoke.small_kernels
    small_ms = chip_smoke.time_ms(small, 100)
    for name, IN, OUT in W8A8_CASES:
        gen = torch.Generator(device=dev).manual_seed(IN + OUT)
        n = chip_smoke.copies_for(IN * OUT)
        layers = []
        for _ in range(n):
            w = torch.randint(-127, 128, (IN, OUT), dtype=torch.int8, device=dev, generator=gen)
            layers.append(qmm.int8_to_gemv(w, torch.rand((OUT,), device=dev, generator=gen) * 1e-4
                                           + 1e-4))
            del w
        for L in (1, 5):
            x = torch.randn((L, IN), device=dev, generator=gen).to(torch.bfloat16)
            same = torch.equal(earlier(x, *layers[0]),
                               qmm.w8a8_gemv(x, *layers[0], counter="w8a8_gemv.wo"))
            old, new = turns(lambda i: earlier(x, *layers[i % n]),
                             lambda i: qmm.w8a8_gemv(x, *layers[i % n], counter="w8a8_gemv.wo"),
                             50, 2)
            old_s, new_s = turns(
                lambda i: (earlier(x, *layers[i % n]), small(i)),
                lambda i: (qmm.w8a8_gemv(x, *layers[i % n], counter="w8a8_gemv.wo"), small(i)),
                50, 2)
            nbytes = IN * OUT + 4 * OUT + 2 * L * IN + 4 * L * OUT
            rows.append(dict(
                kernel=name, L=L, IN=IN, OUT=OUT, earlier_ms=old, ms=new,
                earlier_after_small_ms=old_s - small_ms, after_small_ms=new_s - small_ms,
                bound_ms=chip_smoke.bound(nbytes, 2 * L * IN * OUT, "int8")[0],
                cols=qmm.w8a8_partition(L, OUT, qmm.sm_count(dev)),
                bit_equal_to_earlier=same,
                cols_ms={c: chip_smoke.time_ms(lambda i: qmm.w8a8_gemv(
                    x, *layers[i % n], counter="w8a8_gemv.wo", cols=c), 50, 2)
                    for c in qmm.GEMV_COLS}))
        del layers


class Rows(list):
    """The result rows, each printed as a JSON line as it comes (a run that
    fails later keeps what it measured)."""

    def append(self, row):
        super().append(row)
        print(json.dumps(row), flush=True)


def turns(fa, fb, iters, warmup=1):
    """(earlier ms, current ms): each the mean of two timings, in the order
    earlier, current, current, earlier."""
    a1 = chip_smoke.time_ms(fa, iters, warmup)
    b1 = chip_smoke.time_ms(fb, iters, warmup)
    b2 = chip_smoke.time_ms(fb, iters, warmup)
    a2 = chip_smoke.time_ms(fa, iters, warmup)
    return (a1 + a2) / 2, (b1 + b2) / 2


def prefill_ab(dev, summary, profile, rows):
    B, H, KVH, P, D, plen_n = 1, 32, 8, 8192, 128, 7928
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((B, H, P, D), device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn((B, KVH, P, D), device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn((B, KVH, P, D), device=dev, generator=gen).to(torch.bfloat16)
    plen = torch.full((B,), plen_n, dtype=torch.int32, device=dev)
    y_old, acc_old = summary(q, k, v, plen)
    y_new, s_new = prefill_attn.flash_prefill(q, k, v, plen_n)
    torch.cuda.synchronize()
    same_y = float((y_old.float() - y_new.float()).abs().max())
    y, ml0, il0 = prefill_attn.flash_pass1(q, k, v)
    old_p1, new_p1 = turns(lambda i: summary(q, k, v, plen, False),
                           lambda i: prefill_attn.flash_pass1(q, k, v), 5)
    old_all, new_all = turns(lambda i: summary(q, k, v, plen),
                             lambda i: prefill_attn.flash_prefill(q, k, v, plen_n), 5)
    new_p2 = chip_smoke.time_ms(lambda i: prefill_attn.flash_pass2(q, k, ml0, il0, plen), 5, 1)
    rows.append(dict(kernel="flash_prefill_summary", P=P, earlier_pass1_ms=old_p1,
                     earlier_pass2_ms=old_all - old_p1, earlier_ms=old_all, pass1_ms=new_p1,
                     pass2_ms=new_p2, ms=new_all, y_max_abs_diff_vs_earlier=same_y))
    for windows in ((2457,), (819, 2457)):
        old, new = turns(lambda i: profile(q, k, v, plen, windows),
                         lambda i: prefill_attn.flash_profile(q, k, v, plen_n, windows), 5)
        new_p2 = chip_smoke.time_ms(
            lambda i: prefill_attn.flash_pass2(q, k, ml0, il0, plen, window_lens=windows), 5, 1)
        rows.append(dict(kernel=f"flash_profile.w{len(windows)}", P=P, earlier_ms=old, ms=new,
                         pass1_ms=new_p1, pass2_ms=new_p2))


def decode_ab(dev, earlier, rows):
    B, H, KVH, D = 1, 32, 8, 128
    G = H // KVH
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for bits, need_attn, C in ((16, False, 2048), (8, True, 2048), (4, False, 2048),
                               (16, False, 32768), (8, False, 32768), (4, False, 32768)):
        gen = torch.Generator(device=dev).manual_seed(2 + bits + C)
        one = chip_smoke._decode_inputs(dev, gen, bits, B, KVH, C, D)
        nbytes = sum(t.numel() * t.element_size() for t in one if t is not None)
        n = chip_smoke.copies_for(nbytes)
        layers = [one] + [chip_smoke._decode_inputs(dev, gen, bits, B, KVH, C, D)
                          for _ in range(n - 1)]
        q = (torch.randn((B, H, 1, D), device=dev, generator=gen) / 4).to(torch.bfloat16)

        def args(i):
            kc, vc, ks, kz, vs, vz, mask = layers[i % n]
            return (q, kc, vc, ks, kz, vs, vz, mask)

        iters = 200 if C <= 4096 else 50
        old, new = turns(lambda i: earlier(*args(i), bits, need_attn),
                         lambda i: decode_attn.decode_attention(*args(i), bits=bits,
                                                                need_attn=need_attn), iters, 2)
        row = dict(kernel=decode_attn.variant(bits, need_attn), C=C, earlier_ms=old, ms=new,
                   bound_ms=chip_smoke.bound(nbytes, 4 * B * H * C * D, "bf16")[0])
        if bits == 16:
            masks = [layers[i][-1].repeat_interleave(G, dim=1)[:, :, None, :] for i in range(n)]
            row["sdpa_ms"] = chip_smoke.time_ms(
                lambda i: sdpa(q, layers[i % n][0], layers[i % n][1], attn_mask=masks[i % n],
                               enable_gqa=True), iters, 2)
        row["cluster"] = decode_attn.default_cluster(B, KVH, C, G, bits, need_attn)
        if C == 32768:
            for nc in (8, 16):
                row[f"cluster{nc}_ms"] = chip_smoke.time_ms(
                    lambda i: decode_attn.decode_attention(*args(i), bits=bits,
                                                           need_attn=need_attn, cluster=nc),
                    iters, 2)
                row[f"cluster{nc}_max_active"] = decode_attn.max_active_clusters(
                    B, KVH, C, G, nc, bits, need_attn)
        rows.append(row)
        del layers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--earlier", required=True, type=Path,
                    help="csrc directory of the earlier sources")
    ap.add_argument("--kernels", default="gemv,evict",
                    help=f"comma-separated groups of {sorted(SOURCES)}")
    args = ap.parse_args()
    groups = [g for g in args.kernels.split(",") if g]
    if not set(groups) <= set(SOURCES):
        ap.error(f"--kernels: {groups} (takes {sorted(SOURCES)})")
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = "cuda"
    card = card_line()
    libs = build_earlier(args.earlier.resolve(), [SOURCES[g] for g in groups])
    _build.build_all()
    rows = Rows()
    rows.append(dict(kernel="launch_floor", ms=chip_smoke.launch_floor_ms()))
    if "gemv" in groups:
        with_cols = "int cols, void* stream" in (args.earlier / "w4a8_gemv.cu").read_text()
        gemv_ab(dev, earlier_gemv(libs["w4a8_gemv"], with_cols), rows)
    if "evict" in groups:
        evict_ab(dev, earlier_evict(libs["hh_evict"]), rows)
    if "decode" in groups:
        decode_ab(dev, earlier_decode(libs["decode_attn"]), rows)
    if "gemm" in groups:
        gemm_ab(dev, earlier_gemm(libs["w4a8_gemm"]), rows)
    if "w8a8" in groups:
        w8a8_ab(dev, earlier_w8a8(libs["w8a8_gemv"]), rows)
    if "prefill" in groups:
        torch.cuda.empty_cache()
        summary, profile = earlier_prefill(libs["flash_prefill"])
        prefill_ab(dev, summary, profile, rows)
    out = ROOT / "chiprun_out"
    os.makedirs(out, exist_ok=True)
    (out / "kernel_ab.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
