#!/usr/bin/env python3
"""On-card smoke run of ``cold_compress_tpu_torch``, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

0. the card's name and power limit (``nvidia-smi``);
1. build the port's CUDA kernels from ``cold_compress_tpu_torch/csrc``
   (``nvcc``, sm_90a, one process per source, all at once);
2. each kernel against its plain PyTorch version on the card at the shapes
   of the Llama-3-8B paths, timed with CUDA events beside its bound: the
   W4A8 projections and head (K1/K2), decode attention at every cache
   precision with and without pooled probabilities at C = 2048 and, for
   bf16/int8/int4 without, at C = 32768 (K3/K5), in both branches of the
   TPU kernel (the dequantizing one, and ``i8dot`` at kv8/kv4/kv2, timed
   beside the dequantizing variant on the same inputs), the fused heavy-hitter
   eviction (K7), the W8A8 head and layer projections (K9, at one and five
   rows, also after an RMS norm's small kernels), flash prefill (K4), flash
   prefill with the FastGen profile (K6) at one and two windows, and the
   W4A8 prefill matmul (K8) at L = 8192 for the four layer projections
   (TOP/s, its quantization launch alone, bit-equal across two launches,
   beside ``torch._int_mm``'s int8 rate);
   decode attention, K1/K2 and K4 also bit-equal across two calls, decode
   attention one device kernel per call (``torch.profiler``), K4 and K6
   with each pass timed alone, K7 also at rows off a 16-byte boundary,
   each K1 shape's column tile, and the launch floor (one
   one-element ``add_``) beside K1/K2/K10 and K7;
3. small in-situ parity: the port on the card (decoding through the
   captured CUDA graph of one step) against the port on the CPU (plain
   versions), TestKernel with int4 weights, teacher-forced, over
   several cache strategies and precisions (heavy_hitter at kv8, bf16, kv4
   and kv2; random kv2; keep_it_odd kv4; recent_global kv8; hybrid kv8 with
   bench.py's menu, one layer's attention sharpened so that the heads pick
   different policies; debug_heavy_hitter with a kv8 shadow), decode
   attention's branch routed as the TPU program routes it (``auto``: i8dot
   for the kv8 caches), and the kv8 runs again with it off and the kv4/kv2
   ones with it on, each with an exact launch witness; the trained TinyByteLM128 fixture's teacher-forced
   NLL in three configurations (int4, kv8 heavy_hitter, hybrid), card
   against CPU;
4. end to end through ``generate()``, decoding through the graph (a warm-up
   run captures it, its seconds and pool bytes printed; the measured run
   replays it), each run with an exact launch witness (every count set to
   0 just before it and read just after):
   - the main path, Llama-3-8B (32 layers, random int4 weights and head
     from seed 0), kv8 heavy_hitter cache at 25% of an 8192 context with
     the heavy_hitter prompt compressor, a 7928-token prompt, 128 greedy
     tokens, decode attention in its i8dot branch (``auto``, as the TPU
     program); then 16 steps from one prefilled state through the graph and
     eagerly, bit-equal in tokens, probabilities and caches; then 64 tokens
     with ``attn_i8dot`` off (the dequantizing branch), beside it;
   - hybrid at bench.py's defaults (its FastGen menu and token classes,
     kv8, C = 8192), the same model and prompt, 64 tokens;
   - the main path's prefill with ``prefill_w4a8`` (K8): its logits against
     the default path's, then 8 tokens;
   - l2 with a kv4 cache and an int8 vocab head, the same model and
     budget, 64 tokens;
   - full with a bf16 cache at a 32768 context on Meta-Llama-3.1-8B-Instruct
     (the same widths and weights, its own rope table), a 32504-token
     prompt, 64 tokens;
   with ``--profile``, after each run, the wall and device time and the
   device operations of a few more decode steps, eager and replayed, and
   ``generate()``'s decode time per step without and with the per-step
   read of the stop flags (a terminator never emitted).

The last three lines of standard output are the card's name and power
limit, one JSON object describing every kernel, and the result line.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
L2_BYTES = 50 * 2**20
REPO_TPU = "cold_compress_tpu"
CSRC = "cold_compress_tpu_torch/csrc"


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, nops: float, op_type: str):
    """Least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.cache
def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    return 10**7 / start.elapsed_time(end)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms per call of ``fn(i)`` over ``iters`` calls, CUDA events.

    A wrapper call costs the host tens of microseconds, longer than a small
    kernel runs, so the card is first held busy (``torch.cuda._sleep``) until
    the host has queued every call: the events then time the device, not
    the host's launch rate. If queuing outlasts the hold, it is retried once
    with a longer hold."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    hold_ms = 20.0
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * sleep_cycles_per_ms()))
        t0 = time.perf_counter()
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if queued_ms < hold_ms:
            break
        hold_ms = 2 * queued_ms
    return start.elapsed_time(end) / iters


def device_kernels_per_call(fn, own, calls: int = 5, warmup: int = 2):
    """(device operations, of them the kernel's own launches) per call of
    ``fn(i)``, from ``torch.profiler``'s device-side events: every kernel,
    copy and fill the call queues, and those whose name holds one of the
    strings ``own``. The first steps are traced and dropped (the tracer can
    miss a launch while it starts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=calls, repeat=1)) as prof:
        for i in range(warmup + calls):
            fn(i)
            torch.cuda.synchronize()
            prof.step()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.count for e in rows) / calls
    mine = sum(e.count for e in rows if any(o in e.key for o in own)) / calls
    return total, mine


@functools.cache
def launch_floor_ms() -> float:
    """``time_ms`` of one elementwise PyTorch op on a one-element tensor: the
    least a launch costs under this timer. A yardstick only; the port never
    calls it."""
    t = torch.zeros(1, device="cuda")
    return time_ms(lambda i: t.add_(1), 200)


@functools.cache
def _norm_input() -> torch.Tensor:
    return torch.randn(1, 4096, device="cuda").to(torch.bfloat16)


def small_kernels(i=0) -> torch.Tensor:
    """An RMS norm's few small kernels, as between two projections of a
    decode step: after them a kernel's instructions are not cached."""
    hf = _norm_input().float()
    return (hf * torch.rsqrt(hf.pow(2).mean(-1, keepdim=True) + 1e-5)).to(torch.bfloat16)


def after_small_ms(fn, iters: int) -> float:
    """``time_ms`` of ``fn(i)`` launched after ``small_kernels``, their own
    time subtracted: a kernel's time as a decode step meets it, cold."""
    both = time_ms(lambda i: (fn(i), small_kernels(i)), iters)
    return both - time_ms(small_kernels, iters)


def copies_for(nbytes: int) -> int:
    """Distinct input buffers to cycle through so that every timed call
    reads its inputs from device memory, as the main path does (each layer
    has its own weights and cache), not from the 50 MB L2."""
    return max(1, min(32, math.ceil(2.5 * L2_BYTES / max(nbytes, 1))))


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_out_err(y: torch.Tensor, ref: torch.Tensor, row_share: float):
    """(max |y - ref|, largest share of its tolerance, the tolerance's text)
    for a bf16 attention output, element by element: one bf16 unit (2**-7
    of the element) where the two sides' f32 values round apart, plus
    ``row_share`` of the row's largest element for the f32 differences
    between the two sides. Late prefill rows average thousands of keys and
    are small, so a bound on the tensor's largest element would not see a
    wrong row."""
    r = ref.float().abs()
    tol = 2**-7 * r + row_share * r.amax(-1, keepdim=True)
    err = (y.float() - ref.float()).abs()
    text = f"2**-7*|ref| + 2**{math.log2(row_share):.0f}*max|ref row|, per element"
    return float(err.max()), float((err / tol.clamp_min(1e-30)).max()), text


def record(records, name, counter, source, replaces, err, tol, ratio, ms, plain_ms,
           b_ms, b_by, library_ms, **extra):
    records.append(dict(
        name=name, counter=counter, route="cuda", source=f"{CSRC}/{source}",
        replaces=f"{REPO_TPU}/{replaces}", max_abs_err=err, tol=tol,
        max_err_over_tol=ratio, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms, **extra,
    ))


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_w4a8(dev, records):
    from cold_compress_tpu_torch.ops import qmm

    gs = 128
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = [  # (counter, IN, OUT, replaces)
        ("w4a8_gemv.wqkv", 4096, 6144, "ops/pallas_qmm.py:712"),
        ("w4a8_gemv.wo", 4096, 4096, "ops/pallas_qmm.py:712"),
        ("w4a8_gemv.w13", 4096, 28672, "ops/pallas_qmm.py:712"),
        ("w4a8_gemv.w2", 14336, 4096, "ops/pallas_qmm.py:712"),
        ("w4a8_gemv.head", 4096, 128256, "ops/pallas_qmm.py:407"),
    ]
    for name, IN, OUT, replaces in shapes:
        ng = IN // gs
        nbytes = IN * OUT // 2 + OUT * ng * 4 + 2 * IN + 4 * OUT
        n = copies_for(nbytes)
        ws = [torch.randint(0, 256, (OUT, IN // 2), dtype=torch.uint8, device=dev,
                            generator=gen) for _ in range(n)]
        szs = []
        for _ in range(n):
            s = torch.rand((OUT, ng), device=dev, generator=gen) * 3e-3 + 1e-3
            z = (torch.rand((OUT, ng), device=dev, generator=gen) - 0.5) * 2e-2
            szs.append(torch.stack([s, z], -1).to(torch.bfloat16).contiguous())
        x = torch.randn((1, IN), device=dev, generator=gen).to(torch.bfloat16)

        y = qmm.w4a8_gemv(x, ws[0], szs[0], gs, counter=name)
        ref = qmm.w4a8_gemv_plain(x, ws[0], szs[0], gs)
        torch.cuda.synchronize()
        assert y.shape == (1, OUT) and bool(torch.isfinite(y).all()), name
        err = max_err(y, ref)
        # Exact int8 x int4 group dots on both sides; only the f32 order of
        # the per-group terms differs.
        tol = 1e-4 * float(ref.abs().max()) + 1e-6
        log(f"[check] {name} IN={IN} OUT={OUT}: max_abs_err={err:.3e} tol={tol:.3e}")
        assert err <= tol, f"{name}: kernel disagrees with its plain version"

        again = qmm.w4a8_gemv(x, ws[0], szs[0], gs, counter=name)
        assert torch.equal(y, again), f"{name}: two launches on the same inputs differ"
        ms = time_ms(lambda i: qmm.w4a8_gemv(x, ws[i % n], szs[i % n], gs, counter=name), 50)
        plain_ms = time_ms(lambda i: qmm.w4a8_gemv_plain(x, ws[i % n], szs[i % n], gs), 5, 1)
        b_ms, b_by = bound(nbytes, 2 * IN * OUT, "int8")
        cols = qmm.gemv_partition(1, OUT, qmm.sm_count(dev))
        log(f"[time] {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
            f"{nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms, library: none; "
            f"{cols} columns per tile, launch floor {launch_floor_ms():.4f} ms")
        record(records, name, name, "w4a8_gemv.cu", replaces, err, "1e-4*max|ref| + 1e-6",
               err / tol, ms, plain_ms, b_ms, b_by, None, cols=cols,
               launch_floor_ms=launch_floor_ms())
        del ws, szs


def _decode_inputs(dev, gen, bits, B, KVH, C, D):
    """One layer's cache at ``bits`` (16 = bf16), partly empty: a different
    fill per head, plus evicted holes."""
    from cold_compress_tpu_torch.caches.base import quantize_rows

    def rows():
        x = torch.randn((B, KVH, C, D), device=dev, generator=gen)
        if bits == 16:
            return x.to(torch.bfloat16), None, None
        return quantize_rows(x, bits)

    kc, ks, kz = rows()
    vc, vs, vz = rows()
    fill = torch.randint(C // 2, C, (B, KVH, 1), device=dev, generator=gen)
    mask = torch.arange(C, device=dev) < fill
    mask &= torch.rand((B, KVH, C), device=dev, generator=gen) > 0.05
    return (kc, vc, ks, kz, vs, vz, mask)


def check_decode(dev, records, bits: int, need_attn: bool, C: int, i8dot: bool = False):
    """K3 (C = 2048, the main path's budget) or K5 (C = 32768, a full
    cache above the TPU's one-shot budget) at one (bits, need_attn), in the
    dequantizing branch or in the ``i8dot`` one (then also the dequantizing
    variant's time on the same inputs)."""
    from cold_compress_tpu_torch.ops import decode_attn

    B, H, KVH, D = 1, 32, 8, 128
    G = H // KVH
    gen = torch.Generator(device=dev).manual_seed(2 + bits + C + int(need_attn))
    counter = decode_attn.variant(bits, need_attn, i8dot)
    plain = (decode_attn.decode_attention_i8dot_plain if i8dot
             else decode_attn.decode_attention_plain)
    name = f"{counter}@C{C}"
    row_bytes = decode_attn.packed_width(bits, D) * (2 if bits == 16 else 1)
    side = 0 if bits == 16 else 4 * 4 * B * KVH * C  # f32 scales and zeros of K and V
    nbytes = (2 * B * KVH * C * row_bytes + side + B * KVH * C  # K, V, their sides, mask
              + 2 * B * H * D + 2 * B * H * D                   # q in, bf16 out
              + (4 * B * KVH * C if need_attn else 0))          # pooled out
    n = copies_for(nbytes)
    layers = [_decode_inputs(dev, gen, bits, B, KVH, C, D) for _ in range(n)]
    q = (torch.randn((B, H, 1, D), device=dev, generator=gen) / 4).to(torch.bfloat16)

    def args(i):
        kc, vc, ks, kz, vs, vz, mask = layers[i % n]
        return (q, kc, vc, ks, kz, vs, vz, mask)

    def run(i, i8=i8dot):
        return decode_attn.decode_attention(*args(i), bits=bits, need_attn=need_attn, i8dot=i8)

    out, pooled = run(0)
    again = run(0)
    ref_out, ref_pooled = plain(*args(0), bits, need_attn)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and (not need_attn or torch.equal(pooled, again[1])), \
        f"{name}: two calls on the same inputs differ"
    # Same roundings on both sides; only the order of the f32 sums differs
    # (the kernel sums 128-slot chunks; i8dot: the int32 dots are exact, its
    # probability scale comes from the cluster's fold).
    err, ratio, tol = bf16_out_err(out, ref_out, 2**-8)
    text = f"out max_abs_err={err:.3e}, max err/tol {ratio:.3f} (tol {tol})"
    ok = ratio <= 1 and bool(torch.isfinite(out).all())
    if need_attn:
        err_p = max_err(pooled, ref_pooled)
        tol_p = 1e-5 * float(ref_pooled.max()) + 1e-8
        text += f"; pooled max_abs_err={err_p:.3e} tol={tol_p:.3e}"
        mask = layers[0][-1]
        ok = ok and err_p <= tol_p and bool((pooled[~mask[:, :, None, :]] == 0).all())
    else:
        ok = ok and pooled is None
    log(f"[check] {name} B={B} H={H} KVH={KVH}: {text}")
    assert ok, f"{name} disagrees with its plain version"

    # One device kernel per call: nothing before it (q is bf16 already) and
    # no cast after it (it writes q's dtype).
    n_dev, n_own = device_kernels_per_call(run, ("decode_attn_kernel",))
    assert n_dev == n_own <= 1, f"{name}: {n_dev} device operations per call, {n_own} its own"
    iters = 200 if C <= 4096 else 50
    ms = time_ms(run, iters)
    plain_ms = time_ms(lambda i: plain(*args(i), bits, need_attn), 10 if C <= 4096 else 3, 1)
    b_ms, b_by = bound(nbytes, 4 * B * H * C * D, "int8" if i8dot else "bf16")
    extra = {}
    if i8dot:
        extra["dequant_ms"] = time_ms(lambda i: run(i, False), iters)
    library_ms, lib_text = None, "none"
    if bits == 16 and not need_attn:
        # The same function in one PyTorch call: masked GQA attention over
        # the bf16 cache, the mask repeated to the query heads beforehand.
        sdpa = torch.nn.functional.scaled_dot_product_attention
        masks = [layers[i][-1].repeat_interleave(G, dim=1)[:, :, None, :] for i in range(n)]
        library_ms = time_ms(lambda i: sdpa(q, layers[i % n][0], layers[i % n][1],
                                            attn_mask=masks[i % n], enable_gqa=True), iters)
        lib_text = f"{library_ms:.4f} ms (scaled_dot_product_attention, enable_gqa)"
    nc = decode_attn.default_cluster(B, KVH, C, G, bits, need_attn, i8dot)
    beside = (f", the dequantizing variant on the same inputs {extra['dequant_ms']:.4f} ms"
              if i8dot else "")
    log(f"[time] {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
        f"{nbytes / ms / 1e6:.1f} GB/s){beside}, plain {plain_ms:.3f} ms, library: {lib_text}; "
        f"{n_dev:g} device kernels per call, clusters of {nc} CTAs")
    if i8dot:  # the i8dot branch of the one-shot kernel, and of the chunked step
        replaces = ("ops/pallas_decode_attn.py:172" if C <= 4096
                    else "ops/pallas_decode_attn.py:274")
    else:
        replaces = ("ops/pallas_decode_attn.py:899" if C <= 4096
                    else "ops/pallas_decode_attn.py:438")
    record(records, name, counter, "decode_attn.cu", replaces, err, tol, ratio, ms, plain_ms,
           b_ms, b_by, library_ms, C=C, device_kernels_per_call=n_dev, cluster=nc, **extra)


def check_hh_evict(dev, records):
    from cold_compress_tpu_torch.ops import evict

    B, H, C, g_tok, recent = 1, 8, 2048, 4, 10
    gen = torch.Generator(device=dev).manual_seed(4)
    nbytes = 3 * 4 * B * H * C + 4 * B + 4 * B * H + 2 * 4 * B * H
    n = copies_for(nbytes)
    rows = []
    for _ in range(n):
        # Dyadic averages give exact ties (the first index must win), and
        # the empty tail is evicted before anything else.
        num = torch.randint(1, 64, (B, H, C), device=dev, generator=gen).float() / 4
        denom = torch.randint(0, 9, (B, H, C), device=dev, generator=gen, dtype=torch.int32)
        pos = torch.stack([torch.randperm(C, device=dev, generator=gen) for _ in range(B * H)])
        pos = pos.reshape(B, H, C).to(torch.int32)
        rows.append((num, denom, pos))
    # Positions are a permutation of 0..C-1: the last few fall in the
    # recent window, the first few are global tokens.
    ipos = torch.full((B, 1, 1), C + 3, dtype=torch.int32, device=dev)

    def run(i):
        num, denom, pos = rows[i % n]
        return evict.hh_evict(num, denom, pos, ipos, global_tokens=g_tok, recent_window=recent)

    for empty in (False, True):
        num, denom, pos = (t.clone() for t in rows[0])
        if empty:
            pos[:, :, -5:] = -1
        n1, d1, n2, d2 = num.clone(), denom.clone(), num.clone(), denom.clone()
        idx = evict.hh_evict(n1, d1, pos, ipos, global_tokens=g_tok, recent_window=recent)
        ref = evict.hh_evict_plain(n2, d2, pos, ipos, g_tok, recent)
        torch.cuda.synchronize()
        same = (torch.equal(idx, ref) and torch.equal(n1.view(torch.int32), n2.view(torch.int32))
                and torch.equal(d1, d2))
        log(f"[check] hh_evict B={B} H={H} C={C} empty_slots={empty}: idx, num and denom "
            f"bit-equal: {same}")
        assert same, "hh_evict disagrees with its plain version"
        if empty:
            assert bool((idx >= C - 5).all()), "an empty slot must be evicted first"

    # Rows off a 16-byte boundary (C % 4 != 0, B = 2): the scalar head and
    # tail inside the kernel.
    for Cm in (2047, 301):
        num = torch.randint(1, 64, (2, H, Cm), device=dev, generator=gen).float() / 4
        denom = torch.randint(0, 9, (2, H, Cm), device=dev, generator=gen, dtype=torch.int32)
        pos = torch.stack([torch.randperm(Cm, device=dev, generator=gen) for _ in range(2 * H)])
        pos = pos.reshape(2, H, Cm).to(torch.int32)
        ip = torch.full((2, 1, 1), Cm + 3, dtype=torch.int32, device=dev)
        n1, d1, n2, d2 = num.clone(), denom.clone(), num.clone(), denom.clone()
        idx = evict.hh_evict(n1, d1, pos, ip, global_tokens=g_tok, recent_window=recent)
        ref = evict.hh_evict_plain(n2, d2, pos, ip, g_tok, recent)
        torch.cuda.synchronize()
        same = (torch.equal(idx, ref) and torch.equal(n1.view(torch.int32), n2.view(torch.int32))
                and torch.equal(d1, d2))
        log(f"[check] hh_evict B=2 H={H} C={Cm}: idx, num and denom bit-equal: {same}")
        assert same, f"hh_evict at C={Cm} disagrees with its plain version"

    ms = time_ms(run, 200)
    plain_ms = time_ms(lambda i: evict.hh_evict_plain(*rows[i % n], ipos, g_tok, recent), 20)
    b_ms, b_by = bound(nbytes, 4 * B * H * C, "bf16")
    log(f"[time] hh_evict: {ms:.4f} ms (bound {b_ms:.6f} ms by {b_by}), plain "
        f"{plain_ms:.4f} ms, library: none; launch floor {launch_floor_ms():.4f} ms")
    record(records, "hh_evict", "hh_evict", "hh_evict.cu", "ops/pallas_evict.py:57", 0.0,
           "bit-equal", 0.0, ms, plain_ms, b_ms, b_by, None, launch_floor_ms=launch_floor_ms())


#: K9's shapes: the int8 vocab head, and the four fused layer projections
#: of an int8 checkpoint (``bench --weight_bits 8``).
W8A8_SHAPES = [  # (counter, IN, OUT)
    ("w8a8_gemv.head", 4096, 128256),
    ("w8a8_gemv.wqkv", 4096, 6144),
    ("w8a8_gemv.wo", 4096, 4096),
    ("w8a8_gemv.w13", 4096, 28672),
    ("w8a8_gemv.w2", 14336, 4096),
]


def check_w8a8(dev, records, name, IN, OUT):
    """K9 at one row (decode) and five (two row blocks), bit-equal to its
    plain version, timed back to back and after small kernels."""
    from cold_compress_tpu_torch.ops import qmm

    gen = torch.Generator(device=dev).manual_seed(5 + IN + OUT)
    nbytes = IN * OUT + 4 * OUT + 2 * IN + 4 * OUT
    n = copies_for(nbytes)
    layers = []
    for _ in range(n):
        w = torch.randint(-127, 128, (IN, OUT), dtype=torch.int8, device=dev, generator=gen)
        s = torch.rand((OUT,), device=dev, generator=gen) * 1e-4 + 1e-4
        layers.append(qmm.int8_to_gemv(w, s))
        del w
    wt, st = layers[0]
    by_rows = {}
    for L in (1, 5):
        x = torch.randn((L, IN), device=dev, generator=gen).to(torch.bfloat16)
        y = qmm.w8a8_gemv(x, wt, st, counter=name)
        ref = qmm.w8a8_gemv_plain(x, wt, st)
        torch.cuda.synchronize()
        err = max_err(y, ref)
        # Exact int32 dots on both sides, the same f32 epilogue in the same
        # order: the same bits.
        same = torch.equal(y, ref)
        log(f"[check] {name} L={L} IN={IN} OUT={OUT}: bit-equal {same}, max_abs_err={err:.3e}")
        assert same and bool(torch.isfinite(y).all()), f"{name} disagrees with its plain version"
        nb = IN * OUT + 4 * OUT + 2 * L * IN + 4 * L * OUT
        ms = time_ms(lambda i: qmm.w8a8_gemv(x, *layers[i % n], counter=name), 50)
        cold = after_small_ms(lambda i: qmm.w8a8_gemv(x, *layers[i % n], counter=name), 50)
        cols = qmm.w8a8_partition(L, OUT, qmm.sm_count(dev))
        b_ms, b_by = bound(nb, 2 * L * IN * OUT, "int8")
        log(f"[time] {name} L={L}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
            f"{nb / ms / 1e6:.1f} GB/s), after small kernels {cold:.4f} ms, {cols} columns "
            f"per tile, launch floor {launch_floor_ms():.4f} ms")
        by_rows[L] = dict(x=x, err=err, ms=ms, cold=cold, cols=cols, b_ms=b_ms, b_by=b_by)
    one = by_rows[1]
    x = one["x"]
    plain_ms = time_ms(lambda i: qmm.w8a8_gemv_plain(x, *layers[i % n]), 3, 1)
    # The library's int8 GEMM: cuBLASLt takes at least 17 rows, so the
    # activations are quantized and padded to 32 rows beforehand.
    xq, sx = qmm.quantize_activations(x)
    xq32 = torch.zeros((32, IN), dtype=torch.int8, device=dev)
    xq32[:1] = xq.to(torch.int8)
    sx32 = torch.ones((32, 1), device=dev)
    sx32[:1] = sx

    def lib(i):
        wt_i, st_i = layers[i % n]
        return (torch._int_mm(xq32, wt_i.t()).float() * st_i) * sx32

    try:
        lib_same = torch.equal(lib(0)[:1], qmm.w8a8_gemv_plain(x, wt, st))
        library_ms = time_ms(lib, 50)
        lib_text = (f"{library_ms:.4f} ms (torch._int_mm on 32 padded rows plus scaling, "
                    f"bit-equal to the plain version: {lib_same})")
    except RuntimeError as e:  # the library call is a yardstick, not a check
        library_ms, lib_text = None, f"none (torch._int_mm failed: {e})"
    log(f"[time] {name}: plain {plain_ms:.3f} ms, library {lib_text}")
    five = by_rows[5]
    record(records, name, name, "w8a8_gemv.cu", "ops/pallas_qmm.py:1293",
           max(one["err"], five["err"]), "bit-equal", 0.0, one["ms"], plain_ms, one["b_ms"],
           one["b_by"], library_ms, cols=one["cols"], after_small_ms=one["cold"],
           ms_l5=five["ms"], bound_ms_l5=five["b_ms"], cols_l5=five["cols"],
           after_small_ms_l5=five["cold"], launch_floor_ms=launch_floor_ms())
    del layers


#: K10's shapes: the unfused rowpack projections of the JAX package's
#: unstacked path (Llama-3-8B), each with the fused counter of the port's
#: projection that computes it.
K10_SHAPES = [  # (label, IN, OUT, counter)
    ("wq", 4096, 4096, "w4a8_gemv.wqkv"),
    ("wk_wv", 4096, 1024, "w4a8_gemv.wqkv"),
    ("w1_w3", 4096, 14336, "w4a8_gemv.w13"),
    ("w2", 14336, 4096, "w4a8_gemv.w2"),
]
CLI_RUN = "generate CLI (int4 checkpoint, heavy_hitter_pyramid kv8)"


def check_k10(dev, records):
    """K10 (the TPU's rowpack layouts of K1's function) runs as K1's kernel
    after the port's one repack. Each leaf is quantized on the card from
    normal weights (per-group scales and zeros that vary); the kernel is
    held against K1's plain version and against the rowpack function
    computed from the unrepacked checkpoint bytes."""
    from cold_compress_tpu_torch.ops import qmm
    from cold_compress_tpu_torch.quantization.weight_quant import quantize_weight_int4

    gs = 128
    gen = torch.Generator(device=dev).manual_seed(10)
    for label, IN, OUT, counter in K10_SHAPES:
        ng = IN // gs
        nbytes = IN * OUT // 2 + OUT * ng * 4 + 2 * IN + 4 * OUT
        n = copies_for(nbytes)
        leaves, packed = [], []
        for _ in range(n):
            leaf = quantize_weight_int4(torch.randn((IN, OUT), device=dev, generator=gen) * 0.02,
                                        gs)
            leaves.append(leaf)
            packed.append(qmm.rowpack_to_gemv(leaf["w"], leaf["scales"], leaf["zeros"]))
        x = torch.randn((1, IN), device=dev, generator=gen).to(torch.bfloat16)
        name = f"k10.{label}"
        y = qmm.w4a8_gemv(x, *packed[0], gs, counter=counter)
        ref = qmm.w4a8_gemv_plain(x, *packed[0], gs)
        lf = leaves[0]
        ref_rp = qmm.w4a8_rowpack_plain(x, lf["w"], lf["scales"], lf["zeros"], gs)
        torch.cuda.synchronize()
        assert y.shape == (1, OUT) and bool(torch.isfinite(y).all()), name
        err, err_rp = max_err(y, ref), max_err(y, ref_rp)
        tol = 1e-4 * float(ref.abs().max()) + 1e-6
        log(f"[check] {name} IN={IN} OUT={OUT}: against K1's plain version max_abs_err="
            f"{err:.3e}, against the rowpack plain version {err_rp:.3e}, tol={tol:.3e}")
        assert err <= tol and err_rp <= tol, f"{name}: kernel disagrees with a plain version"

        ms = time_ms(lambda i: qmm.w4a8_gemv(x, *packed[i % n], gs, counter=counter), 50)
        plain_ms = time_ms(lambda i: qmm.w4a8_gemv_plain(x, *packed[i % n], gs), 5, 1)
        b_ms, b_by = bound(nbytes, 2 * IN * OUT, "int8")
        cols = qmm.gemv_partition(1, OUT, qmm.sm_count(dev))
        log(f"[time] {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
            f"{nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms, library: none; "
            f"{cols} columns per tile, launch floor {launch_floor_ms():.4f} ms")
        record(records, name, counter, "w4a8_gemv.cu", "ops/pallas_qmm.py:294", max(err, err_rp),
               "1e-4*max|ref| + 1e-6", max(err, err_rp) / tol, ms, plain_ms, b_ms, b_by, None,
               cols=cols, launch_floor_ms=launch_floor_ms(),
               from_run=CLI_RUN, also_replaces=[f"{REPO_TPU}/ops/pallas_qmm.py:215",
                                                f"{REPO_TPU}/ops/pallas_qmm.py:407 (flat)",
                                                f"{REPO_TPU}/ops/pallas_qmm.py:890"])
        del leaves, packed


PREFILL_KERNELS = ("flash_fwd_kernel", "colsum_kernel", "colsum_reduce")


def pass_times(q, k, v, plen: int, windows=None):
    """ms of K4's (or, with ``windows``, K6's) pass 1 alone and of pass 2
    with its reduction alone, on the same inputs."""
    from cold_compress_tpu_torch.ops import prefill_attn

    plen_t = torch.full((q.shape[0],), plen, dtype=torch.int32, device=q.device)
    _, mbuf, ilbuf = prefill_attn.flash_pass1(q, k, v)
    pass1 = time_ms(lambda i: prefill_attn.flash_pass1(q, k, v), 5, 1)
    pass2 = time_ms(lambda i: prefill_attn.flash_pass2(q, k, mbuf, ilbuf, plen_t,
                                                       window_lens=windows), 5, 1)
    return pass1, pass2


def check_flash_prefill(dev, records):
    from cold_compress_tpu_torch.ops import prefill_attn

    B, H, KVH, P, D, plen = 1, 32, 8, 8192, 128, 7928
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((B, H, P, D), device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn((B, KVH, P, D), device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn((B, KVH, P, D), device=dev, generator=gen).to(torch.bfloat16)

    y, summ = prefill_attn.flash_prefill(q, k, v, plen, need_summary=True)
    y2, summ2 = prefill_attn.flash_prefill(q, k, v, plen, need_summary=True)
    assert torch.equal(y, y2) and all(torch.equal(summ[key], summ2[key]) for key in summ), \
        "flash_prefill_summary: two calls on the same inputs differ"
    del y2, summ2
    ref_y, ref_summ = prefill_attn.flash_prefill_plain(q, k, v, plen, need_summary=True)
    torch.cuda.synchronize()
    # The kernel rounds the unnormalised probabilities to bf16 before P.V,
    # the plain version the normalised ones (the two TPU paths differ the
    # same way): each probability moves by up to 2**-9 on each side; over
    # many keys these moves mostly cancel and stay well under 2**-7 of the
    # row's largest element. Summaries are f32 on both sides.
    err, ratio, tol = bf16_out_err(y, ref_y, 2**-7)
    errs = {key: max_err(summ[key], ref_summ[key]) for key in ("obs_mean", "cum_mean")}
    tols = {key: 1e-4 * float(ref_summ[key].abs().max()) + 1e-7 for key in errs}
    log(f"[check] flash_prefill_summary P={P} prompt_len={plen}: y max_abs_err={err:.3e}, "
        f"max err/tol {ratio:.3f} (tol {tol}); "
        + "; ".join(f"{k} max_abs_err={e:.3e} tol={tols[k]:.3e}" for k, e in errs.items()))
    assert ratio <= 1 and all(errs[k] <= tols[k] for k in errs), \
        "flash_prefill_summary disagrees with its plain version"
    assert float(summ["cum_mean"][..., plen:].abs().max()) == 0.0

    ms = time_ms(lambda i: prefill_attn.flash_prefill(q, k, v, plen, need_summary=True), 5, 1)
    pass1_ms, pass2_ms = pass_times(q, k, v, plen)
    n_dev, n_own = device_kernels_per_call(
        lambda i: prefill_attn.flash_prefill(q, k, v, plen, need_summary=True), PREFILL_KERNELS)
    plain_ms = time_ms(lambda i: prefill_attn.flash_prefill_plain(q, k, v, plen), 2, 1)
    nbytes = 2 * (2 * B * H * P * D + 2 * B * KVH * P * D) + 2 * 4 * B * KVH * P
    pairs = B * H * P * (P + 1) // 2  # causal (query, key) pairs
    b_ms, b_by = bound(nbytes, 4 * D * pairs, "bf16")
    kr = k.repeat_interleave(H // KVH, dim=1)
    vr = v.repeat_interleave(H // KVH, dim=1)
    sdpa_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, is_causal=True), 5, 1)
    log(f"[time] flash_prefill_summary: {ms:.3f} ms (pass 1 {pass1_ms:.3f}, pass 2 and its "
        f"reduction {pass2_ms:.3f}; bound {b_ms:.3f} ms by {b_by}; "
        f"{4 * D * pairs / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, library: none "
        f"(scaled_dot_product_attention, causal y only, no summaries: {sdpa_ms:.3f} ms); "
        f"{n_dev:g} device operations per call, {n_own:g} of them the kernel's")
    record(records, "flash_prefill_summary", "flash_prefill_summary", "flash_prefill.cu",
           "ops/pallas_prefill.py:167", err, tol, ratio, ms, plain_ms, b_ms, b_by, None,
           pass1_ms=pass1_ms, pass2_ms=pass2_ms, device_kernels_per_call=n_dev,
           own_kernels_per_call=n_own, sdpa_causal_y_ms=sdpa_ms)


def check_flash_profile(dev, records, windows):
    """K6 at the hybrid prefill's shapes: the bench menu's one window
    (2457 = int(0.3 * 8192)) and a two-window menu."""
    from cold_compress_tpu_torch.ops import prefill_attn

    B, H, KVH, P, D, plen = 1, 32, 8, 8192, 128, 7928
    gen = torch.Generator(device=dev).manual_seed(7 + len(windows))
    q = torch.randn((B, H, P, D), device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn((B, KVH, P, D), device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn((B, KVH, P, D), device=dev, generator=gen).to(torch.bfloat16)

    y, cum, wcols = prefill_attn.flash_profile(q, k, v, plen, window_lens=windows)
    ref_y, ref_cum, ref_w = prefill_attn.flash_profile_plain(q, k, v, plen, windows)
    torch.cuda.synchronize()
    # y: as K4's check. cum and wcols: f32 sums of the same f32
    # probabilities on both sides, in another order.
    err, ratio, tol = bf16_out_err(y, ref_y, 2**-7)
    errs = {"cum": max_err(cum, ref_cum), "wcols": max_err(wcols, ref_w)}
    tols = {"cum": 1e-4 * float(ref_cum.abs().max()), "wcols": 1e-4 * float(ref_w.abs().max())}
    name = f"flash_profile.w{len(windows)}"
    log(f"[check] {name} P={P} prompt_len={plen} windows={windows}: y max_abs_err={err:.3e}, "
        f"max err/tol {ratio:.3f} (tol {tol}); "
        + "; ".join(f"{key} max_abs_err={e:.3e} tol={tols[key]:.3e}" for key, e in errs.items()))
    assert ratio <= 1 and all(errs[key] <= tols[key] for key in errs), \
        f"{name} disagrees with its plain version"
    assert float(cum[..., plen:].abs().max()) == 0.0 and wcols.shape == (len(windows), B, KVH, P)
    del ref_y, ref_cum, ref_w

    ms = time_ms(lambda i: prefill_attn.flash_profile(q, k, v, plen, window_lens=windows), 5, 1)
    pass1_ms, pass2_ms = pass_times(q, k, v, plen, windows)
    n_dev, n_own = device_kernels_per_call(
        lambda i: prefill_attn.flash_profile(q, k, v, plen, window_lens=windows), PREFILL_KERNELS)
    plain_ms = time_ms(lambda i: prefill_attn.flash_profile_plain(q, k, v, plen, windows), 1, 1)
    nbytes = 2 * (2 * B * H * P * D + 2 * B * KVH * P * D) + 4 * (1 + len(windows)) * B * KVH * P
    pairs = B * H * P * (P + 1) // 2  # causal (query, key) pairs
    # QK^T and PV over the causal pairs, as K4's bound; pass 2's recompute
    # of QK^T is the kernel's own choice and is not counted.
    b_ms, b_by = bound(nbytes, 4 * D * pairs, "bf16")
    kr = k.repeat_interleave(H // KVH, dim=1)
    vr = v.repeat_interleave(H // KVH, dim=1)
    sdpa_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, is_causal=True), 5, 1)
    log(f"[time] {name}: {ms:.3f} ms (pass 1 {pass1_ms:.3f}, pass 2 and its reduction "
        f"{pass2_ms:.3f}; bound {b_ms:.3f} ms by {b_by}; "
        f"{4 * D * pairs / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, library: none "
        f"(scaled_dot_product_attention, causal y only, no profile: {sdpa_ms:.3f} ms); "
        f"{n_dev:g} device operations per call, {n_own:g} of them the kernel's")
    record(records, name, "flash_profile", "flash_prefill.cu", "ops/pallas_prefill.py:281",
           err, tol, ratio, ms, plain_ms, b_ms, b_by, None, windows=list(windows),
           pass1_ms=pass1_ms, pass2_ms=pass2_ms, device_kernels_per_call=n_dev,
           own_kernels_per_call=n_own, sdpa_causal_y_ms=sdpa_ms)


def check_w4a8_gemm(dev, records):
    """K8 at L = 8192 for the four 8B layer projections: against K1's plain
    version, bit-equal across two launches, its activation quantization
    (the first of its two launches) timed alone, and beside two asides that
    are not the same function: the default path's dequantize + bf16
    ``torch.matmul``, and ``torch._int_mm`` on int8 [L, IN] x [IN, OUT] (the
    rate the library gets from the int8 tensor cores)."""
    from cold_compress_tpu_torch.ops import qmm

    gs, L = 128, 8192
    gen = torch.Generator(device=dev).manual_seed(8)
    shapes = [("w4a8_gemm.wqkv", 4096, 6144), ("w4a8_gemm.wo", 4096, 4096),
              ("w4a8_gemm.w13", 4096, 28672), ("w4a8_gemm.w2", 14336, 4096)]
    for name, IN, OUT in shapes:
        ng = IN // gs
        wg = torch.randint(0, 256, (OUT, IN // 2), dtype=torch.uint8, device=dev, generator=gen)
        s = torch.rand((OUT, ng), device=dev, generator=gen) * 3e-3 + 1e-3
        z = (torch.rand((OUT, ng), device=dev, generator=gen) - 0.5) * 2e-2
        sz = torch.stack([s, z], -1).to(torch.bfloat16).contiguous()
        x = torch.randn((L, IN), device=dev, generator=gen).to(torch.bfloat16)

        y = qmm.w4a8_gemm(x, wg, sz, gs, counter=name)
        ref = qmm.w4a8_gemv_plain(x, wg, sz, gs)
        torch.cuda.synchronize()
        assert y.shape == (L, OUT) and bool(torch.isfinite(y).all()), name
        err = max_err(y, ref)
        # K1's tolerance: exact integer group dots, only f32 order differs.
        tol = 1e-4 * float(ref.abs().max()) + 1e-6
        same = torch.equal(y, qmm.w4a8_gemm(x, wg, sz, gs, counter=name))
        log(f"[check] {name} L={L} IN={IN} OUT={OUT}: max_abs_err={err:.3e} tol={tol:.3e}, "
            f"two launches bit-equal {same}")
        assert err <= tol, f"{name}: kernel disagrees with its plain version"
        assert same, f"{name}: two launches on the same inputs differ"
        del ref

        ms = time_ms(lambda i: qmm.w4a8_gemm(x, wg, sz, gs, counter=name), 5, 1)
        quant_ms = time_ms(lambda i: qmm.w4a8_gemm_quantize(x, gs), 5, 1)
        plain_ms = time_ms(lambda i: qmm.w4a8_gemv_plain(x, wg, sz, gs), 1, 1)
        dense_ms = time_ms(lambda i: torch.matmul(x, qmm.dequantize_gemv(wg, sz, gs)), 5, 1)
        xq = qmm.w4a8_gemm_quantize(x, gs)[0]
        w8 = torch.randint(-8, 8, (OUT, IN), dtype=torch.int8, device=dev, generator=gen)
        int_mm_ms = time_ms(lambda i: torch._int_mm(xq, w8.t()), 5, 1)
        del xq, w8
        nbytes = IN * OUT // 2 + OUT * ng * 4 + 2 * L * IN + 4 * L * OUT
        nops = 2 * L * IN * OUT
        b_ms, b_by = bound(nbytes, nops, "int8")
        q_ms, _ = bound(2 * L * IN + L * IN + 4 * L + 4 * L * ng, 0, "int8")
        log(f"[time] {name}: {ms:.3f} ms (bound {b_ms:.3f} ms by {b_by}; "
            f"{nops / ms / 1e9:.1f} TOP/s), of which the activation quantization "
            f"{quant_ms:.4f} ms (its bound {q_ms:.4f} ms by bytes), plain {plain_ms:.3f} ms, "
            f"library: none (no PyTorch call computes W4A8). Asides: the default path's "
            f"dequantize + torch.matmul in bf16 {dense_ms:.3f} ms; torch._int_mm int8 "
            f"[{L}, {IN}] x [{IN}, {OUT}] {int_mm_ms:.3f} ms ({nops / int_mm_ms / 1e9:.1f} TOP/s)")
        record(records, name, name, "w4a8_gemm.cu", "ops/pallas_qmm.py:1177", err,
               "1e-4*max|ref| + 1e-6", err / tol, ms, plain_ms, b_ms, b_by, None,
               tops=nops / ms / 1e9, quant_ms=quant_ms, quant_bound_ms=q_ms,
               bit_equal_across_launches=same, dense_matmul_ms=dense_ms, int_mm_ms=int_mm_ms,
               also_replaces=f"{REPO_TPU}/ops/pallas_qmm.py:1100")
        del wg, sz, x, y


# ---------------------------------------------------------------------------
# Phases 3 and 4: through generate()
# ---------------------------------------------------------------------------


def cache_kw(strategy: str, bits: int) -> dict:
    """The port's ``bench`` cache options at its defaults (25% budget, 4
    global tokens) for ``strategy`` at ``bits`` (16 = bf16)."""
    from cold_compress_tpu_torch.bench import cache_kwargs

    return cache_kwargs(strategy, 0.25, 4, None if bits == 16 else bits)


def build_model(name: str, seed: int, device: str, context: int):
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params
    from cold_compress_tpu_torch.runtime.engine import build_model as build, params_from_flat

    cfg = ModelConfig.from_name(name)
    flat = random_quantized_params(cfg, seed=seed, head_mode="int4")
    params = params_from_flat(flat, device)
    del flat
    model = build(cfg, params, device, max_positions=context)
    del params
    return cfg, model


def make_caches(cfg, kw: dict, context: int, device: str):
    from cold_compress_tpu_torch.models.transformer import init_caches
    from cold_compress_tpu_torch.runtime.engine import build_cache_specs, cache_compatibility

    cache_compatibility(kw)
    return init_caches(cfg, build_cache_specs(cfg, kw, context), 1, torch.bfloat16,
                       device=device)


def expected_launches(cfg, kw: dict, steps: int, lengths, head: str = "w4a8_gemv.head",
                      prefill_w4a8: bool = False, layers: str = "w4a8_gemv",
                      i8dot="auto") -> dict:
    """Exact kernel launches of a run of ``steps`` decode steps (plus the
    prefill) at head_dim 128: every projection (``layers`` names their
    kernel, None for dense bf16 layers) and the head (``head``, None for a
    dense one) once per step (the head once more for the prefill's last
    row), decode attention per layer per step at the cache's precision, one
    flash prefill per layer (the profiling one, K6, for hybrid), and the
    fused eviction per layer per step for a one-slot heavy-hitter history (a
    debug_heavy_hitter shadow's too). A debug_* cache attends over its full
    bf16 outer cache with pooled probabilities. Each layer's decode attention
    takes the branch that ``i8dot`` (a ``set_attn_i8dot`` mode) routes its
    cache length (``lengths``, per layer) to. With ``prefill_w4a8`` each
    layer projection also runs K8 once, at prefill."""
    from cold_compress_tpu_torch.caches import get_cache_strategy
    from cold_compress_tpu_torch.ops import decode_attn

    n = cfg.n_layer
    strategy = kw["cache_strategy"][0]
    bits = kw["cache_bits"] or 16
    needs_attn = get_cache_strategy(strategy).needs_attn
    evicting = strategy
    if strategy == "hybrid":
        needs_attn = any("heavy_hitter" in e["strategy"] for e in kw["hybrid_strategies"])
    elif strategy.startswith("debug_"):
        bits, evicting = 16, strategy[len("debug_"):]
    projections = ("wqkv", "wo", "w13", "w2")
    want = {f"{layers}.{p}": n * steps for p in projections} if layers else {}
    if prefill_w4a8:
        want.update({f"w4a8_gemm.{p}": n for p in projections})
    if head:
        want[head] = steps + 1
    for C in lengths:
        i8 = decode_attn.i8dot_route(i8dot, bits, C, cfg.n_kv_head, cfg.head_dim)
        key = decode_attn.variant(bits, needs_attn, i8)
        want[key] = want.get(key, 0) + steps
    want["flash_profile" if strategy == "hybrid" else "flash_prefill_summary"] = n
    if evicting == "heavy_hitter" and kw.get("history_window_size", 1) == 1:
        want["hh_evict"] = n * steps
    return want


def cache_lengths(caches) -> list:
    """Each layer's cache length, as decode attention's routing reads it."""
    return [c.k.shape[2] for c in caches]


def witness(run_name: str, C: int, launches: dict, want: dict, runs: list) -> None:
    got = {k: v for k, v in launches.items() if v}
    assert got == want, f"{run_name} routing witness: got {got}, want {want}"
    runs.append((run_name, C, got))


IN_SITU = [  # (strategy, cache bits, kept positions must match exactly, layer weights,
    #            decode attention's i8dot mode)
    ("heavy_hitter", 8, False, "int4", "auto"),
    ("random", 2, True, "int4", "auto"),
    ("keep_it_odd", 4, True, "int4", "auto"),
    ("heavy_hitter", 16, False, "int4", "auto"),
    ("heavy_hitter", 4, False, "int4", "auto"),
    ("heavy_hitter", 2, False, "int4", "auto"),
    ("recent_global", 8, True, "int4", "auto"),
    ("hybrid", 8, False, "int4", "auto"),
    ("debug_heavy_hitter", 8, False, "int4", "auto"),
    ("heavy_hitter", 8, False, "int8", "auto"),
    ("heavy_hitter", 8, False, "bf16", "auto"),
    # The other branch where auto takes one: kv8 dequantizing, kv4/kv2 i8dot.
    ("heavy_hitter", 8, False, "int4", False),
    ("recent_global", 8, True, "int4", False),
    ("heavy_hitter", 4, False, "int4", True),
    ("keep_it_odd", 4, True, "int4", True),
    ("heavy_hitter", 2, False, "int4", True),
    ("random", 2, True, "int4", True),
]
#: Layer and head kernels by weight kind: random int4 weights
#: (``random_quantized_params``), ``init_params`` quantized to int8 layers
#: and head (``quantize_params(mode="int8")``), and ``init_params`` as they
#: are (dense bf16, no kernel).
WEIGHT_KERNELS = {"int4": ("w4a8_gemv", "w4a8_gemv.head"),
                  "int8": ("w8a8_gemv", "w8a8_gemv.head"), "bf16": (None, None)}
#: The in-situ hybrid run's threshold: with layer 1's attention sharpened
#: (see ``sharpened_layer``), bench.py's menu sends layer 0's head to
#: special_punc_heavy_hitter (its heavy hitters recover ~0.901 of the
#: prompt attention) and layer 1's to special_punc_heavy_hitter_window
#: (heavy hitters alone ~0.869).
HYBRID_IN_SITU_RECOVERY = 0.885


def sharpened_layer(tree, factor: float = 8.0):
    """Scale layer 1's query and key int4 scales and zeros by a power of two
    (exact in bf16): its scores grow by factor**2 and its attention peaks.
    Random weights otherwise give every head the same near-uniform
    attention, so every hybrid head would pick the same policy."""
    for name in ("wq", "wk"):
        leaf = tree["layers"][1]["attn"][name]
        for key in ("scales", "zeros"):
            leaf[key] = leaf[key] * factor  # a new tensor: CPU leaves share the flat arrays
    return tree


@contextlib.contextmanager
def recorded_profile_scores():
    """Keep each hybrid prefill's menu scores [S, B, KVH], layer by layer,
    in the list this yields (the caller clears it before a run)."""
    from cold_compress_tpu_torch.caches import hybrid

    scores = []
    finalize = hybrid._profile_finalize

    def recording(*args, **kw):
        cum_attn, s = finalize(*args, **kw)
        scores.append(s.cpu())
        return cum_attn, s

    hybrid._profile_finalize = recording
    try:
        yield scores
    finally:
        hybrid._profile_finalize = finalize


def tree_to(node, device):
    """A parameter tree with every tensor moved to ``device``."""
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, dict):
        return {k: tree_to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_to(v, device) for v in node]
    return node


def in_situ_parity(dev, runs: list):
    from cold_compress_tpu_torch.models.transformer import init_params, prefill, set_attn_i8dot
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.quantization.weight_quant import (
        quantize_params, random_quantized_params,
    )
    from cold_compress_tpu_torch.runtime.engine import build_model as build, params_from_flat
    from cold_compress_tpu_torch.runtime.generate import generate

    prompt = np.random.RandomState(0).randint(2, 500, size=300).tolist()
    forced = np.random.RandomState(1).randint(2, 500, size=8).tolist()
    forced_punc = forced[:2] + [20] + forced[3:5] + [33] + forced[6:]  # bench's punctuation
    tokens = prompt + [0] * (512 - len(prompt))
    built = {device: build_model("TestKernel", 0, device, 512) for device in (dev, "cpu")}
    cfg = built["cpu"][0]
    models = {"int4": {device: model for device, (_, model) in built.items()}}
    flat = random_quantized_params(cfg, seed=0, head_mode="int4")
    sharp = {device: build(cfg, sharpened_layer(params_from_flat(flat, device)), device,
                           max_positions=512) for device in (dev, "cpu")}
    dense = init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    for kind, tree in (("bf16", dense), ("int8", quantize_params(dense, "int8",
                                                                 output_mode="int8"))):
        models[kind] = {device: build(cfg, tree_to(tree, device), device, max_positions=512)
                        for device in (dev, "cpu")}
    with recorded_profile_scores() as scores:
        for strategy, bits, exact_pos, weights, i8dot in IN_SITU:
            kw = cache_kw(strategy, bits)
            forced_s = forced
            if strategy == "hybrid":
                kw["min_recovery_frac"] = HYBRID_IN_SITU_RECOVERY
                forced_s = forced_punc
            out, steps = {}, {}
            for device in (dev, "cpu"):
                model = sharp[device] if strategy == "hybrid" else models[weights][device]
                set_attn_i8dot(model, i8dot)
                caches = make_caches(cfg, kw, 512, device)
                with torch.inference_mode():
                    logits = prefill(model, caches, torch.tensor([tokens], device=device),
                                     len(prompt))
                caches = make_caches(cfg, kw, 512, device)
                scores.clear()
                reset_kernel_launches()
                seq, info, caches = generate(model, caches, prompt, 8, prefill_bucket=512,
                                             next_tokens=forced_s)
                launches = kernel_launches()
                steps[device] = info["perf_stats"]["decode_steps"]
                assert seq == prompt + forced_s and steps[device] == len(forced_s) - 1
                extra = {key: np.stack([c.extra[key].cpu().numpy() for c in caches])
                         for key in ("strategy_idx", "attention_losses") if key in caches[0].extra}
                extra["scores"] = [s.numpy() for s in scores]
                out[device] = (logits[0].float().cpu().numpy(), np.asarray(info["emitted_probs"]),
                               np.asarray(info["final_probs"]),
                               np.stack([c.pos.cpu().numpy() for c in caches]), launches, extra)
                set_attn_i8dot(model, "auto")
            (l_g, e_g, f_g, pos_g, launches, x_g), (l_c, e_c, f_c, pos_c, cpu_launches, x_c) = (
                out[dev], out["cpu"])
            run_name = f"in-situ TestKernel {strategy} kv{bits}" + (
                f", {weights} layers" if weights != "int4" else "") + (
                f", attn_i8dot {'on' if i8dot else 'off'}" if i8dot != "auto" else "")
            assert not any(cpu_launches.values()), "CPU tensors must take the plain versions"
            layer_kernel, head_kernel = WEIGHT_KERNELS[weights]
            witness(run_name, caches[0].spec.max_cache_length, launches,
                    expected_launches(cfg, kw, steps[dev], cache_lengths(caches), head_kernel,
                                      layers=layer_kernel, i8dot=i8dot), runs)
            if strategy == "hybrid":
                check_hybrid_policies(run_name, x_g, x_c, kw["min_recovery_frac"])
            if "attention_losses" in x_c:
                gap_loss = float(np.abs(x_g["attention_losses"] - x_c["attention_losses"]).max())
                log(f"[parity] {run_name}: attention_losses per layer (cpu) "
                    f"{x_c['attention_losses'][:, :7].mean(-1).round(5).tolist()}, max gap "
                    f"{gap_loss:.3e} (tol 2e-2)")
                assert np.all(x_c["attention_losses"][:, 7:] == -1.0), run_name
                assert gap_loss <= 2e-2, run_name
            # Prefill logits come before any eviction: only summation order and
            # the bf16 roundings that follow from it differ.
            gap_l = float(np.abs(l_g - l_c).max())
            tol_l = 2e-2 * float(l_c.max() - l_c.min())
            # Decode probabilities also carry the evictions; the heavy-hitter
            # ones follow near-ties of the history on random weights and so may
            # pick other slots on the card than on the CPU. The others depend on
            # positions (and the counter-based draws) only: the same slots.
            gap = float(np.abs(e_g - e_c).max())
            gap_f = float(np.abs(f_g - f_c).max())
            tol = 5e-2 * float(e_c.max())
            same_pos = float((pos_g == pos_c).mean())
            log(f"[parity] {run_name} cuda vs cpu: prefill logits max gap {gap_l:.3e} "
                f"(tol {tol_l:.3e}); teacher-forced emitted_probs max gap {gap:.3e}, final_probs "
                f"max gap {gap_f:.3e} (tol {tol:.3e}); kept positions equal: {same_pos:.4f}"
                + (" (must be 1)" if exact_pos else ""))
            assert np.all(np.isfinite(l_g)) and gap_l <= tol_l, run_name
            assert np.all(np.isfinite(e_g)) and gap <= tol and gap_f <= tol, run_name
            assert same_pos == 1.0 or not exact_pos, f"{run_name}: kept positions differ"


def quantize_on_card_matches_cpu(dev):
    """The port's quantization on the card gives the CPU's bytes, for one
    8B layer's wq (4096 -> 4096) and w2 (14336 -> 4096), int4 and int8."""
    from cold_compress_tpu_torch.quantization.weight_quant import (
        quantize_weight_int4, quantize_weight_int8,
    )
    from cold_compress_tpu_torch.runtime.engine import flatten_params

    gen = torch.Generator(device=dev).manual_seed(9)
    for name, IN, OUT in (("wq", 4096, 4096), ("w2", 14336, 4096)):
        w = (torch.randn((IN, OUT), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        for fn in (quantize_weight_int4, quantize_weight_int8):
            card, cpu = flatten_params(fn(w)), flatten_params(fn(w.cpu()))
            same = sorted(card) == sorted(cpu) and all(
                card[k].dtype == cpu[k].dtype and card[k].tobytes() == cpu[k].tobytes()
                for k in cpu)
            log(f"[parity] {fn.__name__} of a {name} {IN}x{OUT} bf16 weight: card and CPU "
                f"byte-identical: {same}")
            assert same, f"{fn.__name__} on the card differs from the CPU"


def cli_args(checkpoint, device, extra=()):
    from cold_compress_tpu_torch.generate import parse_args

    return parse_args(["--device", device, "--checkpoint_path", str(checkpoint), "--cache_config",
                       "heavy_hitter_pyramid", "--max_cache_length", "0.25", "--cache_bits", "8",
                       *extra])


def cli_kw(args) -> dict:
    """The cache options of a parsed CLI run, for ``expected_launches``."""
    return {k: getattr(args, k) for k in ("cache_strategy", "cache_bits", "history_window_size")}


def in_situ_cli(dev, runs: list):
    """The generate CLI over an int4 TestKernel checkpoint quantized and
    saved on the CPU, with ``heavy_hitter_pyramid`` (per-layer budgets of
    ragged length): greedy on the card, then the card's tokens
    teacher-forced through the same CLI on the CPU."""
    import tempfile

    from cold_compress_tpu_torch.generate import PROMPTS_DIR, run
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import init_params
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.quantization.weight_quant import quantize_params
    from cold_compress_tpu_torch.runtime.engine import save_params

    cfg = ModelConfig.from_name("TestKernel")
    params = init_params(cfg, torch.Generator().manual_seed(3), torch.bfloat16, "cpu")
    text = (PROMPTS_DIR / "long_prompt_short_output.txt").read_text()[:400]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = f"{tmp}/byte/TestKernel/model_int4.g128.npz"
        save_params(quantize_params(params, "int4", 128, output_mode="int4"), path)
        extra = ("--max_new_tokens", "8", "--prompt", text)
        args = cli_args(path, dev, extra)
        reset_kernel_launches()
        seq, info, caches = run(args)
        launches = kernel_launches()
        P = info["prompt_length"]
        seq_c, info_c, caches_c = run(cli_args(path, "cpu", extra), next_tokens=seq[P:])
    run_name = "in-situ TestKernel generate CLI heavy_hitter_pyramid kv8"
    lengths = [c.spec.max_cache_length for c in caches]
    witness(run_name, lengths[0], launches,
            expected_launches(cfg, cli_kw(args), info["perf_stats"]["decode_steps"],
                              cache_lengths(caches)), runs)
    e_g, e_c = np.asarray(info["emitted_probs"]), np.asarray(info_c["emitted_probs"])
    f_g, f_c = np.asarray(info["final_probs"]), np.asarray(info_c["final_probs"])
    gap, gap_f, tol = float(np.abs(e_g - e_c).max()), float(np.abs(f_g - f_c).max()), \
        5e-2 * float(e_c.max())
    log(f"[parity] {run_name}: cache lengths {lengths}, prompt {P} tokens, card tokens "
        f"{seq[P:]}; card vs cpu (the card's tokens forced): emitted_probs max gap {gap:.3e}, "
        f"final_probs max gap {gap_f:.3e} (tol {tol:.3e})")
    assert seq_c == seq and len(set(lengths)) > 1 and any(n % 128 for n in lengths), run_name
    assert np.all(np.isfinite(e_g)) and gap <= tol and gap_f <= tol, run_name


#: The trained-weight check: ``tests/fixtures/TinyByteLM128-hf`` (a trained
#: byte-level Llama, head_dim 128, G = 2: every kernel gate passes), the
#: criterion of ``tests/test_quality_gates.py`` (the first 400 bytes of
#: ``BENCHMARK.md``, a 256-byte prompt, 96 teacher-forced bytes, mean NLL
#: over the forced bytes), in three configurations: int4 weights
#: (``quantize_params``, group size 128, int4 head) over a full bf16
#: cache, and the trained bf16 weights over a kv8 ``heavy_hitter`` cache at
#: a quarter of 512 slots and over a kv8 ``hybrid`` cache (bench.py's
#: FastGen menu, punctuation bytes as its punctuation class).
#: ``tests/test_torch_trained.py`` holds the CPU run against the JAX package.
TRAINED_CKPT = "tests/fixtures/TinyByteLM128-hf/model.npz"
TRAINED_MAX_SEQ = 512
TRAINED_CONFIGS = {  # name: (layer and head weights, cache options)
    "int4": ("int4", {"cache_strategy": ["full"], "max_cache_length": [1.0],
                      "prompt_compression_strategy": ["full"], "cache_bits": None}),
    "kv8_heavy_hitter": ("bf16", {
        "cache_strategy": ["heavy_hitter"], "max_cache_length": [0.25],
        "prompt_compression_strategy": ["heavy_hitter"], "global_tokens": 4,
        "recent_window": 10, "cache_bits": 8}),
    "hybrid": ("bf16", {
        "cache_strategy": ["hybrid"], "max_cache_length": [1.0],
        "prompt_compression_strategy": ["full"], "global_tokens": 4, "recent_window": 10,
        "cache_bits": 8,  # and bench.py's menu (trained_kw)
        "token_ids": {"special": [[256], [257]],
                      "punctuation": [ord(c) for c in ".,;:!?()`|-\n"]}}),
}
#: |card NLL - CPU NLL| (nats per byte): kernels against their plain
#: versions, which differ in f32 summation order only.
TRAINED_CARD_TOL = 5e-3


def repo_path(rel: str) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)


def trained_tokens():
    """(prompt, forced) byte tokens of the trained-weight check."""
    with open(repo_path("BENCHMARK.md"), encoding="utf-8") as f:
        tokens = list(f.read()[:400].encode("utf-8"))
    return tokens[:256], tokens[256:352]


def trained_kw(name: str) -> dict:
    from cold_compress_tpu_torch.bench import HYBRID_MENU

    kw = dict(TRAINED_CONFIGS[name][1])
    if kw["cache_strategy"] == ["hybrid"]:
        kw["hybrid_strategies"] = HYBRID_MENU
    return kw


def trained_nll(name: str, device: str, cuda_graph=None, attn_i8dot="auto"):
    """The port's teacher-forced mean NLL on the trained fixture in
    configuration ``name``, with decode attention's ``attn_i8dot`` mode:
    (NLL, decode steps)."""
    from cold_compress_tpu_torch.models.transformer import init_caches
    from cold_compress_tpu_torch.quantization.weight_quant import quantize_params
    from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model, load_model
    from cold_compress_tpu_torch.runtime.generate import generate

    prompt, forced = trained_tokens()
    cfg, params = load_model(repo_path(TRAINED_CKPT), model_name="TinyByteLM128", device=device)
    if TRAINED_CONFIGS[name][0] == "int4":
        params = quantize_params(params, "int4", 128, output_mode="int4")
    model = build_model(cfg, params, device, max_positions=TRAINED_MAX_SEQ,
                        attn_i8dot=attn_i8dot)
    caches = init_caches(cfg, build_cache_specs(cfg, trained_kw(name), TRAINED_MAX_SEQ), 1,
                         torch.bfloat16, device=device)
    seq, info, _ = generate(model, caches, prompt, len(forced), prefill_bucket=TRAINED_MAX_SEQ,
                            next_tokens=forced, cuda_graph=cuda_graph)
    assert seq == prompt + forced
    probs = np.asarray(info["emitted_probs"], np.float64)
    return float(np.mean(-np.log(np.maximum(probs, 1e-20)))), info["perf_stats"]["decode_steps"]


def trained_parity(dev, runs: list):
    """The trained-weight check on the card, decoding through the graph,
    against the CPU: each configuration's NLL within ``TRAINED_CARD_TOL``,
    with its exact launch witness."""
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.engine import build_cache_specs

    cfg = ModelConfig.from_name("TinyByteLM128")
    for name, (weights, _) in TRAINED_CONFIGS.items():
        reset_kernel_launches()
        card, steps = trained_nll(name, dev, cuda_graph=True)
        launches = kernel_launches()
        cpu, _ = trained_nll(name, "cpu")
        run_name = f"trained TinyByteLM128 {name}"
        log(f"[parity] {run_name}: teacher-forced mean NLL card (graph) {card:.6f}, cpu "
            f"{cpu:.6f} nats/byte, gap {abs(card - cpu):.2e} (tol {TRAINED_CARD_TOL})")
        assert card < 3.0 and abs(card - cpu) <= TRAINED_CARD_TOL, run_name
        layer_kernel, head_kernel = WEIGHT_KERNELS[weights]
        lengths = [s.max_cache_length
                   for s in build_cache_specs(cfg, trained_kw(name), TRAINED_MAX_SEQ)]
        witness(run_name, TRAINED_MAX_SEQ, launches,
                expected_launches(cfg, trained_kw(name), steps, lengths, head_kernel,
                                  layers=layer_kernel), runs)


def check_hybrid_policies(run_name, on_card, on_cpu, min_recovery: float):
    """The policy of every head, on the card against the CPU: equal, but
    for heads whose recovery score lies within 1e-3 of the threshold (their
    share is printed); and at least two distinct policies."""
    sidx_g, sidx_c = on_card["strategy_idx"], on_cpu["strategy_idx"]
    scores = np.stack(on_cpu["scores"])  # [layers, S, B, KVH]
    near = (np.abs(scores - min_recovery) < 1e-3).any(axis=1)  # [layers, B, KVH]
    chosen = sorted(set(sidx_c.flatten().tolist()))
    log(f"[parity] {run_name}: policies (cpu) {sidx_c.reshape(len(sidx_c), -1).tolist()}, "
        f"card equal: {bool((sidx_g == sidx_c).all())}, heads within 1e-3 of "
        f"min_recovery_frac {min_recovery}: {float(near.mean()):.3f}; scores per layer "
        f"{[s[:, 0, 0].round(4).tolist() for s in scores]}")
    assert len(chosen) >= 2, f"{run_name}: one policy for every head: {chosen}"
    assert bool(((sidx_g == sidx_c) | near).all()), f"{run_name}: policies differ"


def device_profile(fn, steps: int):
    """(device busy ms per step, device operations per step, the rows by
    time) of ``fn()`` run once over ``steps`` steps, from ``torch.profiler``'s
    device-side events (kernels, copies, fills; the host-side aten rows
    carry the same device time again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    return busy_ms, sum(e.count for e in rows) / steps, rows


def profile_decode(model, caches, token: int, start_pos: int, steps: int, card: str,
                   run_name: str):
    """Where a decode step's time goes, eager and replayed: wall time per
    step without the profiler, and device time per step by kernel from
    ``torch.profiler``, for ``decode_step`` run eagerly and for the model's
    captured decode graph replayed (its own positions and tokens)."""
    from cold_compress_tpu_torch.models.transformer import decode_step
    from cold_compress_tpu_torch.runtime.cuda_graph import model_decode_graph

    def run(tok, pos):
        for i in range(steps):
            tok = decode_step(model, caches, tok, pos + i).argmax(-1)
        return tok

    graph = model_decode_graph(model)
    assert graph is not None and graph.captured, f"{run_name}: no decode graph to replay"

    def replay():
        with graph.on_stream():
            for _ in range(steps):
                graph.replay()

    tok = torch.tensor([token], device="cuda")
    with torch.inference_mode():
        tok = run(tok, start_pos)  # warm
        replay()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = run(tok, start_pos + steps)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        wall = {"eager": (t1 - t0) * 1e3 / steps,
                "graph": (time.perf_counter() - t1) * 1e3 / steps}
        prof = {"eager": device_profile(lambda: run(tok, start_pos + 2 * steps), steps),
                "graph": device_profile(replay, steps)}
    for kind in ("eager", "graph"):
        busy_ms, n_ops, rows = prof[kind]
        log(f"[profile] {run_name}, {kind} step: wall {wall[kind]:.3f} ms, device busy "
            f"{busy_ms:.3f} ms (idle {100 * (1 - busy_ms / wall[kind]):.1f}%), {n_ops:.0f} "
            f"device operations per step  [{card}]")
        for e in rows[:12]:
            log(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
                f"{e.count / steps:6.1f}/step  {e.key[:90]}")


def e2e_run(run_name, cfg, model, kw, context, new_tokens, dev, card, runs, head_counter,
            profile=False, layers="w4a8_gemv", eager_check=False):
    """One ``generate()`` run at full width, decoding through the captured
    graph, after a short warm-up that captures it, with its launch witness
    and output checks; with ``eager_check``, then the graph against eager
    steps from one state; with ``profile``, then a profile of a few more
    decode steps, eager and replayed."""
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.generate import generate, reset_caches

    caches = make_caches(cfg, kw, context, dev)
    prompt_len = context - 256 - 8  # bench.py's prompt length
    prompt = np.random.RandomState(0).randint(5, cfg.vocab_size - 5, size=prompt_len).tolist()
    # Warm-up: cuBLAS, the allocator, and the capture of the decode graph.
    _, warm, _ = generate(model, caches, prompt, 8)
    log_capture(run_name, warm, card)
    reset_caches(caches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    seq, info, caches = generate(model, caches, prompt, new_tokens)
    launches = kernel_launches()
    perf = info["perf_stats"]
    steps = perf["decode_steps"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert not info["decode_graph"]["captured"], f"{run_name}: the timed run captured again"
    log(f"[e2e] {run_name}: launches {json.dumps({k: v for k, v in launches.items() if v})}")
    log(f"[e2e] {run_name}: C={caches[0].spec.max_cache_length}, prefill "
        f"{perf['prefill_seconds']:.4f} s for {prompt_len} tokens "
        f"({perf['prefill_toks_per_sec']:.1f} tok/s); decode {perf['decode_toks_per_sec']:.3f} "
        f"tok/s over {steps} steps (graph replays); peak memory {peak_gb:.3f} GB  [{card}]")

    hybrid = kw["cache_strategy"][0] == "hybrid"
    check_outputs(run_name, cfg, seq, info, caches, prompt_len, new_tokens, hybrid)
    if hybrid:
        from cold_compress_tpu_torch.caches.hybrid import HybridCache

        spec = caches[0].spec
        hist = sum(HybridCache.strategy_histogram(spec, c) for c in caches) / len(caches)
        kept = torch.stack([c.cache_ct.float() for c in caches])
        log(f"[e2e] {run_name}: policy histogram over {len(caches)} layers x "
            f"{caches[0].cache_ct.numel()} heads: "
            + ", ".join(f"{e.strategy} {h:.4f}" for e, h in zip(spec.hybrid_strategies,
                                                                 hist.tolist()))
            + f"; kept slots per head min {int(kept.min())}, mean {float(kept.mean()):.1f}, "
              f"max {int(kept.max())} of C={spec.max_cache_length}")
    witness(run_name, caches[0].spec.max_cache_length, launches,
            expected_launches(cfg, kw, steps, cache_lengths(caches), head_counter,
                              layers=layers, i8dot=model.attn_i8dot), runs)
    if eager_check:
        graph_matches_eager(run_name, model, caches, prompt, dev)
    if profile:
        profile_decode(model, caches, seq[-1], len(seq), 8, card, run_name)
        stop_read_cost(model, caches, prompt, cfg.vocab_size, card, run_name)
    return perf


def log_capture(run_name, info, card):
    """Print the decode graph that a ``generate()`` call captured (its info)."""
    graph = info["decode_graph"]
    assert graph is not None and graph["captured"], f"{run_name}: no decode graph captured"
    log(f"[e2e] {run_name}: decode graph captured in {graph['capture_seconds']:.3f} s, pool "
        f"{graph['pool_bytes']} bytes, {sum(graph['launches_per_replay'].values())} kernel "
        f"launches per replay  [{card}]")


def graph_matches_eager(run_name, model, caches, prompt, dev, steps: int = 16):
    """From one prefilled state, ``steps`` greedy steps through the decode
    graph and the same steps eagerly (``decode_loop_core``): the same
    tokens, probabilities, last distribution, every cache tensor and kernel
    launches, bit for bit."""
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.generate import decode_loop_core, generate, reset_caches

    reset_caches(caches)
    seq, _, caches = generate(model, caches, prompt, 1)  # prefill and the first token only
    tensors = [t for c in caches for t in c.tensors()]
    start = [t.clone() for t in tensors]
    first = torch.tensor([seq[-1]], device=dev)
    out = {}
    for graph in (True, False):
        for t, t0 in zip(tensors, start):
            t.copy_(t0)
        reset_kernel_launches()
        tokens, probs, last, n, record = decode_loop_core(model, caches, first, len(prompt), [],
                                                          [], steps, cuda_graph=graph)
        out[graph] = ([tokens.cpu(), probs.cpu(), last.cpu()], [t.cpu() for t in tensors],
                      kernel_launches(), n, record)
    (g_out, g_cache, g_launch, g_n, record), (e_out, e_cache, e_launch, e_n, _) = (
        out[True], out[False])
    same_out = all(torch.equal(a, b) for a, b in zip(g_out, e_out))
    same_cache = all(torch.equal(a, b) for a, b in zip(g_cache, e_cache))
    log(f"[e2e] {run_name}: {steps} steps from one prefilled state, graph (capture in this "
        f"call: {record['captured']}) against eager: tokens, probabilities bit-equal "
        f"{same_out}; all {len(tensors)} cache tensors bit-equal {same_cache}; launches equal "
        f"{g_launch == e_launch}; tokens {g_out[0][:, 0].tolist()}")
    assert same_out and same_cache and g_launch == e_launch and g_n == e_n == steps, run_name


def stop_read_cost(model, caches, prompt, never: int, card: str, run_name: str, tokens=16):
    """Decode ms per step of ``generate()`` without terminators (no read of
    the stop flags inside the loop) and with one that is never emitted (one
    read per step, ``never`` being out of the vocabulary), in turns: the
    host-side cost of stopping where the reference stops."""
    from cold_compress_tpu_torch.runtime.generate import generate, reset_caches

    ms = {False: [], True: []}
    for stop in (False, True, True, False):
        reset_caches(caches)
        _, info, _ = generate(model, caches, prompt, tokens,
                              terminator_ids=[never] if stop else None)
        perf = info["perf_stats"]
        assert perf["decode_steps"] == tokens - 1, run_name
        ms[stop].append(perf["decode_seconds"] * 1e3 / perf["decode_steps"])
    log(f"[profile] {run_name}: generate() decode ms per step without a stop read "
        f"{ms[False]}, with one read per step {ms[True]}  [{card}]")


def prefill_w4a8_run(cfg, model, dev, card, runs):
    """The main path with ``prefill_w4a8``: prefill logits against the
    default (bf16 dequantization) path's on the same prompt, then an
    8-token ``generate()`` with its launch witness."""
    from cold_compress_tpu_torch.models.transformer import prefill, set_prefill_w4a8
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.generate import generate, reset_caches

    run_name = "main path, prefill_w4a8"
    kw = cache_kw("heavy_hitter", 8)
    caches = make_caches(cfg, kw, 8192, dev)
    prompt_len = 8192 - 256 - 8
    prompt = np.random.RandomState(0).randint(5, cfg.vocab_size - 5, size=prompt_len).tolist()
    tokens = torch.tensor([prompt + [0] * (8192 - prompt_len)], device=dev)
    logits = {}
    try:
        for on in (False, True):
            set_prefill_w4a8(model, on)
            reset_caches(caches)
            with torch.inference_mode():
                logits[on] = prefill(model, caches, tokens, prompt_len)[0].float()
        reset_caches(caches)
        torch.cuda.synchronize()
        reset_kernel_launches()
        t0 = time.perf_counter()
        seq, info, caches = generate(model, caches, prompt, 8)
        launches = kernel_launches()
    finally:
        set_prefill_w4a8(model, False)
    steps = info["perf_stats"]["decode_steps"]
    ref, got = logits[False], logits[True]
    cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=0))
    gap = max_err(got, ref)
    same_top = int(got.argmax()) == int(ref.argmax())
    log(f"[e2e] {run_name}: prefill logits against the bf16-dequant path: cosine {cos:.6f} "
        f"(bound 0.99), max gap {gap:.4e} (logit range {float(ref.max() - ref.min()):.3f}), "
        f"same argmax {same_top}; prefill {info['perf_stats']['prefill_seconds']:.4f} s, "
        f"run {time.perf_counter() - t0:.2f} s  [{card}]")
    log(f"[e2e] {run_name}: launches {json.dumps({k: v for k, v in launches.items() if v})}")
    log_capture(run_name, info, card)
    assert bool(torch.isfinite(got).all()) and cos >= 0.99, run_name
    assert len(seq) == prompt_len + 8 and steps == 7, run_name
    witness(run_name, caches[0].spec.max_cache_length, launches,
            expected_launches(cfg, kw, steps, cache_lengths(caches), prefill_w4a8=True), runs)


def check_outputs(run_name, cfg, seq, info, caches, prompt_len, new_tokens, hybrid=False):
    """Finite outputs of the expected shapes, and caches that hold each
    position once: filled to their length and ending on the last decoded
    token, or, for hybrid's per-head budgets, each head within its cache."""
    steps = info["perf_stats"]["decode_steps"]
    gen_tokens = seq[prompt_len:]
    assert steps == new_tokens - 1 and len(gen_tokens) == new_tokens, run_name
    assert all(0 <= t < cfg.vocab_size for t in gen_tokens), run_name
    final = np.asarray(info["final_probs"])
    assert final.shape == (cfg.vocab_size,) and np.all(np.isfinite(final)), run_name
    assert abs(float(final.sum()) - 1.0) < 1e-3, run_name
    emitted = np.asarray(info["emitted_probs"])
    assert emitted.shape == (new_tokens,) and np.all((emitted > 0) & (emitted <= 1)), run_name
    for c in caches:
        C = c.spec.max_cache_length
        pos = c.pos[0].cpu().numpy()
        assert all(len(set(r[r >= 0].tolist())) == int((r >= 0).sum()) for r in pos), run_name
        if hybrid:
            assert int(c.cache_ct.max()) <= C, run_name
            assert torch.equal(c.cache_ct, c.mask.sum(-1).to(torch.int32)), run_name
        else:
            assert int(c.cache_ct.min()) == min(C, prompt_len + steps), run_name
            assert int(pos.max()) == prompt_len + new_tokens - 2, run_name  # the last token


def scratch_dir(need_bytes: int) -> str:
    """A new directory with ``need_bytes`` free: under the temporary
    directory, else under the checkout's git-ignored ``build/``. Raises if
    neither has the room."""
    import os
    import shutil
    import tempfile

    for base in (tempfile.gettempdir(), repo_path("build")):
        os.makedirs(base, exist_ok=True)
        free = shutil.disk_usage(base).free
        log(f"[e2e] {base}: {free / 1e9:.1f} GB free, {need_bytes / 1e9:.1f} GB needed")
        if free >= need_bytes:
            return tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=base)
    raise RuntimeError(f"no directory with {need_bytes / 1e9:.1f} GB free for the checkpoint")


def cli_full_run(dev, card, runs):
    """The quantize/generate CLI path at Llama-3-8B's full width and depth:
    random bf16 weights drawn on the card, ``quantize_params(mode="int4",
    group_size=128, output_mode="int4")`` (what ``quantize --mode int4``
    does) leaf by leaf on the card, ``save_params`` to a ``byte`` path, then
    ``generate.run`` over that file with ``heavy_hitter_pyramid`` kv8 at 25%
    (per-layer budgets: the JAX package's unstacked rowpack path, K10), the
    default prompt file cut to 8064 byte tokens, 128 greedy tokens."""
    import os
    import shutil

    from cold_compress_tpu_torch.generate import run
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import init_params, model_size_bytes
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.quantization.weight_quant import quantize_params
    from cold_compress_tpu_torch.runtime.engine import save_params

    name = "Meta-Llama-3-8B-Instruct"
    cfg = ModelConfig.from_name(name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    quantized = quantize_params(params, "int4", 128, output_mode="int4")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bf16_gb = model_size_bytes(params) / 1e9
    del params
    log(f"[e2e] {name} bf16 weights drawn on the card in {t1 - t0:.1f} s ({bf16_gb:.2f} GB "
        f"without embeddings), quantized to int4 on the card in {t2 - t1:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    tmp = scratch_dir(7 * 10**9)
    try:
        path = os.path.join(tmp, "byte", name, "model_int4.g128.npz")
        t0 = time.perf_counter()
        save_params(quantized, path)
        write_s = time.perf_counter() - t0
        del quantized
        torch.cuda.empty_cache()
        log(f"[e2e] save_params: {os.path.getsize(path)} bytes written in {write_s:.1f} s "
            f"to {path}")
        args = cli_args(path, dev, ("--max_new_tokens", "128"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launches()
        seq, info, caches = run(args)
        launches = kernel_launches()
    finally:
        shutil.rmtree(tmp)
    perf = info["perf_stats"]
    P = info["prompt_length"]
    lengths = [c.spec.max_cache_length for c in caches]
    log(f"[e2e] {CLI_RUN}: launches {json.dumps({k: v for k, v in launches.items() if v})}")
    log(f"[e2e] {CLI_RUN}: load {info['load_seconds']:.1f} s, per-layer C {lengths}, prefill "
        f"{perf['prefill_seconds']:.4f} s for {P} tokens ({perf['prefill_toks_per_sec']:.1f} "
        f"tok/s); decode {perf['decode_toks_per_sec']:.3f} tok/s over {perf['decode_steps']} "
        f"steps; peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB  [{card}]")
    log(f"[e2e] {CLI_RUN}: generation {info['generation'][:80]!r}")
    log_capture(CLI_RUN, info, card)
    assert P == 8064, f"{CLI_RUN}: prompt of {P} tokens, want 8192 - 128"
    assert len(set(lengths)) > 1 and any(n % 128 for n in lengths), lengths
    check_outputs(CLI_RUN, cfg, seq, info, caches, P, 128)
    witness(CLI_RUN, lengths[0], launches,
            expected_launches(cfg, cli_kw(args), perf["decode_steps"], cache_lengths(caches)), runs)


def int8_bench_run(dev, card, runs, profile=False):
    """``bench --weight_bits 8`` at bench's defaults: int8 layers from
    ``random_quantized_params(mode="int8")`` (whose head is int8 too, as
    in the JAX package), kv8 heavy_hitter at 25% of 8192, 64 tokens."""
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params
    from cold_compress_tpu_torch.runtime.engine import build_model as build, params_from_flat

    cfg = ModelConfig.from_name("Meta-Llama-3-8B-Instruct")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flat = random_quantized_params(cfg, seed=0, mode="int8", head_mode="int4")
    model = build(cfg, params_from_flat(flat, dev), dev, max_positions=8192)
    del flat
    torch.cuda.synchronize()
    log(f"[e2e] Llama-3-8B int8 built in {time.perf_counter() - t0:.1f} s")
    e2e_run("bench --weight_bits 8 (int8 layers and head)", cfg, model,
            cache_kw("heavy_hitter", 8), 8192, 64, dev, card, runs, "w8a8_gemv.head", profile,
            layers="w8a8_gemv")


def end_to_end(dev, card, runs, profile=False):
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import (
        make_linear, make_rope_table, set_attn_i8dot,
    )

    t0 = time.perf_counter()
    cfg, model = build_model("Meta-Llama-3-8B-Instruct", 0, dev, 8192)
    torch.cuda.synchronize()
    log(f"[e2e] Llama-3-8B built in {time.perf_counter() - t0:.1f} s: {cfg.n_layer} layers, "
        f"load peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # The main path: bench.py's default configuration (decode attention in
    # the i8dot branch, as the TPU program routes it).
    main = e2e_run("main path (heavy_hitter kv8, int4 head)", cfg, model,
                   cache_kw("heavy_hitter", 8), 8192, 128, dev, card, runs, "w4a8_gemv.head",
                   profile, eager_check=True)

    # The main path with decode attention's dequantizing branch (bench
    # --attn_i8dot off), beside it.
    set_attn_i8dot(model, False)
    try:
        off = e2e_run("main path, attn_i8dot off", cfg, model, cache_kw("heavy_hitter", 8), 8192,
                      64, dev, card, runs, "w4a8_gemv.head")
    finally:
        set_attn_i8dot(model, "auto")
    log(f"[e2e] main path decode tok/s: attn_i8dot auto (i8dot) "
        f"{main['decode_toks_per_sec']:.3f} over {main['decode_steps']} steps, off "
        f"{off['decode_toks_per_sec']:.3f} over {off['decode_steps']} steps  [{card}]")

    # FastGen hybrid at bench.py's defaults (its menu and token classes).
    e2e_run("hybrid kv8 (bench's FastGen menu)", cfg, model, cache_kw("hybrid", 8), 8192, 64,
            dev, card, runs, "w4a8_gemv.head", profile)

    # The main path's prefill through the W4A8 prefill kernel (K8).
    prefill_w4a8_run(cfg, model, dev, card, runs)

    # l2 over a kv4 cache with an int8 vocab head: the same layers, an int8
    # head drawn as random_quantized_params(head_mode="int8") draws its
    # values ((byte % 255) - 127, scales 0.02 / 127).
    int4_head = model.output
    gen = torch.Generator(device=dev).manual_seed(6)
    w8 = (torch.randint(0, 255, (cfg.dim, cfg.vocab_size), device=dev, generator=gen,
                        dtype=torch.int16) - 127).to(torch.int8)
    s8 = torch.full((cfg.vocab_size,), 0.02 / 127, device=dev)
    model.output = make_linear({"kind": "int8", "w": w8, "scales": s8}, "head")
    del w8
    e2e_run("l2 kv4, int8 head", cfg, model, cache_kw("l2", 4), 8192, 64, dev, card, runs,
            "w8a8_gemv.head", profile)
    model.output = int4_head

    # A full bf16 cache at 32k on Llama-3.1-8B: the same widths, so the
    # same weights, with its own rope table (llama3 scaling).
    cfg31 = ModelConfig.from_name("Meta-Llama-3.1-8B-Instruct")
    assert (cfg31.dim, cfg31.n_layer, cfg31.n_head, cfg31.n_kv_head, cfg31.intermediate_size,
            cfg31.vocab_size) == (cfg.dim, cfg.n_layer, cfg.n_head, cfg.n_kv_head,
                                  cfg.intermediate_size, cfg.vocab_size)
    model.cfg = cfg31
    model.rope = make_rope_table(cfg31, 32768, device=dev)
    torch.cuda.empty_cache()
    e2e_run("full bf16, 32k, Llama-3.1-8B", cfg31, model, cache_kw("full", 16), 32768, 64, dev,
            card, runs, "w4a8_gemv.head", profile)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after each end-to-end run, profile a few decode steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card.",
              file=sys.stderr)
        return 2
    from cold_compress_tpu_torch.bench import card_line
    from cold_compress_tpu_torch.ops import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    card = card_line()
    assert card, "nvidia-smi did not give the card's name and power limit"
    log(f"[card] {card} | torch.cuda: {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernel sources built in {time.perf_counter() - t0:.1f} s "
        f"into {_build.BUILD_INFO['dir']}")
    for name, text in _build.BUILD_INFO["logs"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    records = []
    check_w4a8(dev, records)
    check_k10(dev, records)
    for bits in (16, 8, 4, 2):
        for need_attn in (True, False):
            check_decode(dev, records, bits, need_attn, 2048)
    for bits in (16, 8, 4):
        check_decode(dev, records, bits, False, 32768)
    for bits in (8, 4, 2):
        for need_attn in (True, False):
            check_decode(dev, records, bits, need_attn, 2048, i8dot=True)
    for bits in (8, 4):
        check_decode(dev, records, bits, False, 32768, i8dot=True)
    check_hh_evict(dev, records)
    for name, IN, OUT in W8A8_SHAPES:
        check_w8a8(dev, records, name, IN, OUT)
    check_flash_prefill(dev, records)
    for windows in ((2457,), (819, 2457)):
        check_flash_profile(dev, records, windows)
    check_w4a8_gemm(dev, records)
    torch.cuda.empty_cache()
    log(f"[phase2] done at {time.perf_counter() - t_start:.1f} s")

    runs = []  # (run name, its cache length, its launches), phase 4 first
    in_situ = []
    in_situ_parity(dev, in_situ)
    in_situ_cli(dev, in_situ)
    trained_parity(dev, in_situ)
    quantize_on_card_matches_cpu(dev)
    log(f"[phase3] done at {time.perf_counter() - t_start:.1f} s")
    end_to_end(dev, card, runs, profile=args.profile)
    log(f"[phase4] bench paths done at {time.perf_counter() - t_start:.1f} s")
    cli_full_run(dev, card, runs)
    log(f"[phase4] CLI run done at {time.perf_counter() - t_start:.1f} s")
    int8_bench_run(dev, card, runs, profile=args.profile)
    runs += in_situ

    # Each kernel's launches come from the run its record names (K10's: the
    # CLI run), else from the first run that drives it: the full-width runs
    # of phase 4, else the in-situ runs of phase 3. A record's C is where
    # phase 2 checked it; path_C is the cache length of the run whose
    # launches it reports.
    kernels = []
    for rec in records:
        path, path_C, n = next(((r, C, got[rec["counter"]]) for r, C, got in runs
                                if rec["counter"] in got
                                and rec.get("from_run", r) == r), (None, None, 0))
        assert n > 0, f"{rec['name']} was launched by no run through generate()"
        kernels.append({**rec, "launches": n, "path": path, "path_C": path_C})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
