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
   attention one device operation per call and K4/K6 their pass kernels
   and PyTorch's own ops only (the nodes of a CUDA graph of one captured
   call), K4 and K6 with each pass timed alone, K7 also at rows off a
   16-byte boundary, the fused insert at the main path's shape,
   each K1 shape's column tile, and the launch floor (one
   one-element ``add_``) beside K1/K2/K10 and K7; and the batched run's
   shapes (``bench --batch 4``): K1/K2 at L = 4 rows (K1 also timed at
   L = 8, two row blocks), decode attention kv8 pooled at B = 4 in its
   i8dot branch (the cluster size printed), K4 at B = 4 with prompt lengths
   7928/7920/7912/7904 (each lane's summaries checked) and K7's fused
   rotate-and-insert (``hh_evict_insert``) at B = 4, and at B = 4 over
   Qwen2-7B's 4 KV heads of 7 queries;
   K4 also at GPTQ's calibration shape (10 sequences of 512, no
   summaries), beside SDPA; Mellum2-12B-A2.5B's kernels at its shapes: the
   grouped expert GEMV (``ops/moe.py::moe_decode``, its two launches per
   group of up to 8 lanes) at B = 1, 4 and 16 lanes of top 8 of 64 experts
   (dim 2304, width 896; lanes sharing experts) against its plain version,
   with its counter of the experts read and its bound from their bytes,
   the expert layer's prefill (``ops/moe.py::moe_prefill``: the grouped
   int4 GEMM's gate/up and down launches and the combine) at the cell's
   4 x 8064 and 4 x 16256 rows against its plain version, exactly those
   three kernels and no matmul in a captured call, each launch timed alone
   beside its bound, its plain version and a per-expert cuBLAS loop over
   the same rows and pre-dequantized weights, K4's window entry
   (``flash_prefill_window``) at 4 lanes of 16384 rows with a 1024-key
   window beside K4's causal pass 1, and K7's ring insert
   (``hh_evict_insert`` with ``window=1024``) at 4 lanes over 4 KV heads of
   8 queries, bit for bit; and one tensor-parallel rank's shapes at
   tp = 2 and 4 (phase 5 launches them): K1 at the four projections' shards
   (wqkv and w13 a tp-th of the columns, wo and w2 of the inputs), K2 at a
   tp-th of the vocabulary, decode attention kv8 pooled in its i8dot branch
   over 8/tp KV heads, the fused insert over 8/tp KV heads; and the query-block forms of K4
   and K6 that phase 6 launches (``flash_prefill_partial``,
   ``flash_profile_partial``): K4 over sp = 2's two shards (4096 rows at
   offsets 0 and 4096 against 8192 keys), sp = 4's last (2048 at 6144) and
   two of the pipeline's 64-row chunks against the keys up to their last
   row (at 4096 and 8128), K6 over sp = 2's second
   shard with one and two windows, each against its plain version with its
   device operations counted exactly, beside SDPA with the block's mask;
   and both at ``q_offset = 0`` bit-equal to K4 and K6;
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
   against CPU; ``generate_batch`` on TestKernel over three prompts of
   300/280/260 tokens, greedy on the card with its launch witness, each
   lane's tokens teacher-forced on the CPU, then the graph against eager
   steps at B = 3 bit for bit; the port's ``eval`` of the trained fixture
   (rulerniah, 8 samples, 4 lanes, kv8 heavy_hitter at 25%) on the card
   against the CPU, each lane's card tokens teacher-forced at batch 1 on
   the CPU and on the card;
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
     with ``attn_i8dot`` off (the dequantizing branch), beside it; then
     ``bench --batch 4``: four lanes of 7928/7920/7912/7904 tokens, 128
     tokens each through ``generate_batch`` (lane 0's first token and
     prefill distribution against the batch-1 run's), and 16 steps of the
     graph against eager at B = 4;
   - hybrid at bench.py's defaults (its FastGen menu and token classes,
     kv8, C = 8192), the same model and prompt, 64 tokens;
   - the main path's prefill with ``prefill_w4a8`` (K8): its logits against
     the default path's, then 8 tokens;
   - l2 with a kv4 cache and an int8 vocab head, the same model and
     budget, 64 tokens;
   - full with a bf16 cache at a 32768 context on Meta-Llama-3.1-8B-Instruct
     (the same widths and weights, its own rope table), a 32504-token
     prompt, 64 tokens;
   - GPTQ (``quantize --mode int4-gptq``'s call) on random bf16
     Llama-3-8B weights drawn on the card, all 32 layers and the head, 10
     random sequences of 512 tokens: K4 once per layer, the seconds by
     part, layer 0's seven matrices and the head against plain rounding on
     the Hessian loss, 256 columns of layer 0's wq against the row-by-row
     contract on the CPU; then the file through ``generate.run`` with
     bench.py's default cache (kv8 heavy_hitter at 25%), 32 tokens;
   - the port's ``eval`` at full width: random int4 Llama-3-8B
     (``--random_quantize int4``), rulerniah, 8 samples, 4 lanes per
     call, kv8 heavy_hitter at 25% of the median sequence, its launch
     witness summed over its calls; then decode attention (the
     dequantizing kv8 pooled variant: its cache length is off the i8dot
     gate) and the fused insert at that run's B = 4 and cache length, against their
     plain versions;
   - Mellum2-12B-A2.5B at full size (random int4 weights and head):
     ``generate_batch`` over four lanes of 8064 tokens, kv8 heavy_hitter
     with SnapKV at C = 2048 on its 7 full layers and a 1024-slot ring on
     each of its 21 sliding layers, 64 tokens each replayed, with its exact
     launch witness (2 x 28 grouped expert GEMV launches, 21 ring inserts
     and 7 fused inserts a step; 21 windowed and 7 causal K4 launches and
     3 x 28 of the experts' grouped GEMM and combine a prefill, no call of
     their plain versions), the distinct experts read per layer and step, every ring
     the last 1024 positions, then 16 steps of the graph against eager;
   with ``--profile``, after each run, the wall and device time and the
   device operations of a few more decode steps, eager and replayed, and
   ``generate()``'s decode time per step without and with the per-step
   read of the stop flags (a terminator never emitted).

5. tensor and data parallelism at full width (``parallel/``), ranks
   started by ``parallel/launch.py``: with four cards, NCCL with one card
   per rank, tp = 2 and tp = 4 over the main path (64 tokens decoding
   through the captured graph, which holds the collectives) and
   ``generate_batch`` at dp = 2 x tp = 2 over the batch run's four lanes;
   with fewer, tp = 2 (NCCL where there are two cards) and dp = 2 x tp = 1
   over two ranks, and tp = 4 (16 tokens) over four, ranks sharing the
   card over gloo (eager decode, correctness only, no timing). Each tp run:
   every rank's greedy tokens equal to the single-card main path's (phase
   4's run) up to the first that parts, which must part at a near-tie of
   that run (``check_greedy``); those tokens teacher-forced, every step's
   probability within TP_PROB_REL of the largest of the single-card run's; an exact launch
   witness on every rank (K1 4 x 32, K2 1, K3 32, the fused insert 32 per token, K4 32
   per prefill); per rank the prefill seconds, decode tok/s and peak
   memory, and over NCCL the all-reduce and all-gather device time per
   replayed step. The dp run: each lane's greedy tokens equal to phase 4's
   single-card lane's, its probabilities within the same bound, and each
   rank's launch witness.

6. sequence and pipeline parallelism at full width (``parallel/sp.py``,
   ``parallel/pp.py``), in the same worlds of ranks as phase 5 (each rank
   draws the weights once): sp = 2 and hybrid under sp = 2 (bench's FastGen
   menu, C = 8192), pp = 2 (chunks of 64 rows), sp = 4, and sp = 2 x tp = 2
   over dense bf16 Llama-3-8B weights (``init_params`` with ``BF16_SEED``,
   each rank keeping its shard of each layer as it is drawn; the single
   card's run of the same weights is its reference), beside bf16 tp = 2 on
   the same weights, and with four cards pp = 4 too. Each run greedy, then
   teacher-forced on the single card's tokens (16 where ranks share the
   card, 64 over NCCL): every rank's greedy tokens the single card's
   (phase 4's runs) up to the first that parts, at a near-tie, every
   probability within TP_PROB_REL of the largest (BF16_PROB_REL for the
   bf16 runs, whose random weights amplify any reordering of a sum; sp x
   tp also within TP_PROB_REL of bf16 tp = 2, token for token), an exact launch witness on every rank
   (the query-block kernel once per layer under sp, once per layer and
   chunk on a pipeline stage; the main path's decode); over NCCL per rank
   the prefill seconds, decode tok/s, peak memory, and one profiled
   prefill's device ms by kind (K/V all-gather, summary all-reduce, the
   pipeline's sends and cache broadcasts, the query-block kernel).

The last three lines of standard output are the card's name and power
limit, one JSON object describing every kernel, and the result line.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
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


#: CUgraphNodeType (cuda.h) of the nodes that are not kernels.
GRAPH_NODE_TYPES = {1: "memcpy", 2: "memset", 3: "host", 4: "child_graph", 5: "empty",
                    6: "event_wait", 7: "event_record", 8: "semaphore_signal",
                    9: "semaphore_wait", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
                    13: "conditional"}


@functools.cache
def _libcuda():
    """The CUDA driver (already loaded by torch), with the signatures of the
    graph-reading calls ``graph_nodes_per_call`` makes."""
    import ctypes

    lib = ctypes.CDLL("libcuda.so.1")
    ptr, names = ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)
    count = ctypes.POINTER(ctypes.c_size_t)
    for fn, args in (("cuGraphGetNodes", [ptr, ctypes.POINTER(ptr), count]),
                     ("cuGraphNodeGetType", [ptr, ctypes.POINTER(ctypes.c_int)]),
                     ("cuGraphKernelNodeGetParams_v2", [ptr, ctypes.POINTER(ctypes.c_uint8)]),
                     ("cuFuncGetName", [names, ptr]), ("cuKernelGetName", [names, ptr])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int  # CUresult
    return lib


def _cu(fn: str, *args) -> None:
    status = getattr(_libcuda(), fn)(*args)
    if status != 0:
        raise RuntimeError(f"{fn}: CUresult {status}")


def graph_nodes_per_call(fn) -> collections.Counter:
    """Every device operation of one call of ``fn(0)``, exactly: the call is
    captured into a CUDA graph (``torch.cuda.CUDAGraph(keep_graph=True)``)
    and its nodes are read back through the driver (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``); a kernel node counts under its function's
    (mangled) name (``cuFuncGetName``), any other node under its type. A
    capture records every launch, so nothing can be dropped, as a profiler
    trace can drop events. A first call runs before, outside the capture."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn(0)
    raw = graph.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    _cu("cuGraphGetNodes", raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _cu("cuGraphGetNodes", raw, nodes, ctypes.byref(n))
    counts = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        _cu("cuGraphNodeGetType", node, ctypes.byref(kind))
        if kind.value != 0:
            counts[GRAPH_NODE_TYPES.get(kind.value, f"type {kind.value}")] += 1
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern (a CUkernel) at 56.
        params = (ctypes.c_uint8 * 128)()
        _cu("cuGraphKernelNodeGetParams_v2", node, params)
        func = ctypes.c_void_p.from_buffer(params, 0).value
        name = ctypes.c_char_p()
        if func:
            _cu("cuFuncGetName", ctypes.byref(name), func)
        else:
            _cu("cuKernelGetName", ctypes.byref(name),
                ctypes.c_void_p.from_buffer(params, 56).value)
        counts[name.value.decode()] += 1
    graph.reset()
    return counts


def own_and_torch(nodes: collections.Counter, own) -> tuple:
    """(each of ``own``'s kernel counts, PyTorch's own kernels, the rest)
    of ``graph_nodes_per_call``'s counts: a kernel is ``own``'s when its
    name holds one of those strings, PyTorch's when it lies in ``at::``."""
    mine = {k: sum(c for n, c in nodes.items() if k in n) for k in own}
    rest = {n: c for n, c in nodes.items() if not any(k in n for k in own)}
    torch_ops = sum(c for n, c in rest.items() if n.startswith("_ZN2at") or "at6native" in n)
    other = {n: c for n, c in rest.items() if not (n.startswith("_ZN2at") or "at6native" in n)}
    return mine, torch_ops, other


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
        replaces=f"{REPO_TPU}/{replaces}" if replaces else None, max_abs_err=err, tol=tol,
        max_err_over_tol=ratio, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms, **extra,
    ))


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_w4a8(dev, records, L: int = 1, also_L=(), from_run=None, tp: int = 1):
    """K1 at the four layer projections and K2 at the head, L activation
    rows (``bench --batch L``: one row per lane), each held against its
    plain version and timed beside its bound; at each ``also_L`` too (a
    second row block: the weights stream again). With ``tp`` at one rank's
    shard of each: the column-parallel wqkv, w13 and head a tp-th of the
    columns, the row-parallel wo and w2 a tp-th of the inputs."""
    from cold_compress_tpu_torch.ops import qmm

    gs = 128
    gen = torch.Generator(device=dev).manual_seed(1 + tp)
    shapes = [  # (counter, IN, OUT, replaces)
        ("w4a8_gemv.wqkv", 4096, 6144 // tp, "ops/pallas_qmm.py:712"),
        ("w4a8_gemv.wo", 4096 // tp, 4096, "ops/pallas_qmm.py:712"),
        ("w4a8_gemv.w13", 4096, 28672 // tp, "ops/pallas_qmm.py:712"),
        ("w4a8_gemv.w2", 14336 // tp, 4096, "ops/pallas_qmm.py:712"),
        ("w4a8_gemv.head", 4096, 128256 // tp, "ops/pallas_qmm.py:407"),
    ]
    for counter, IN, OUT, replaces in shapes:
        name = counter + (f"@L{L}" if L > 1 else "") + (f"@tp{tp}" if tp > 1 else "")
        ng = IN // gs

        def nbytes_at(rows):
            return IN * OUT // 2 + OUT * ng * 4 + 2 * IN * rows + 4 * OUT * rows

        nbytes = nbytes_at(L)
        n = copies_for(nbytes)
        ws = [torch.randint(0, 256, (OUT, IN // 2), dtype=torch.uint8, device=dev,
                            generator=gen) for _ in range(n)]
        szs = []
        for _ in range(n):
            s = torch.rand((OUT, ng), device=dev, generator=gen) * 3e-3 + 1e-3
            z = (torch.rand((OUT, ng), device=dev, generator=gen) - 0.5) * 2e-2
            szs.append(torch.stack([s, z], -1).to(torch.bfloat16).contiguous())
        timed = {}
        for rows in (L, *also_L):
            x = torch.randn((rows, IN), device=dev, generator=gen).to(torch.bfloat16)
            y = qmm.w4a8_gemv(x, ws[0], szs[0], gs, counter=counter)
            ref = qmm.w4a8_gemv_plain(x, ws[0], szs[0], gs)
            torch.cuda.synchronize()
            assert y.shape == (rows, OUT) and bool(torch.isfinite(y).all()), name
            err = max_err(y, ref)
            # Exact int8 x int4 group dots on both sides; only the f32 order of
            # the per-group terms differs.
            tol = 1e-4 * float(ref.abs().max()) + 1e-6
            log(f"[check] {name} IN={IN} OUT={OUT} L={rows}: max_abs_err={err:.3e} "
                f"tol={tol:.3e}")
            assert err <= tol, f"{name} at L={rows}: kernel disagrees with its plain version"
            again = qmm.w4a8_gemv(x, ws[0], szs[0], gs, counter=counter)
            assert torch.equal(y, again), f"{name}: two launches on the same inputs differ"
            ms = time_ms(lambda i: qmm.w4a8_gemv(x, ws[i % n], szs[i % n], gs, counter=counter),
                         50)
            plain_ms = time_ms(lambda i: qmm.w4a8_gemv_plain(x, ws[i % n], szs[i % n], gs), 5, 1)
            b_ms, b_by = bound(nbytes_at(rows), 2 * IN * OUT * rows, "int8")
            cols = qmm.gemv_partition(rows, OUT, qmm.sm_count(dev))
            log(f"[time] {name} L={rows}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
                f"{nbytes_at(rows) / ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms, library: none; "
                f"{cols} columns per tile, {-(-rows // qmm.GEMV_ROWS)} row blocks, launch floor "
                f"{launch_floor_ms():.4f} ms")
            timed[rows] = (err, tol, ms, plain_ms, b_ms, b_by, cols)
        err, tol, ms, plain_ms, b_ms, b_by, cols = timed[L]
        extra = {f"{key}_L{rows}": val for rows in also_L for key, val in zip(
            ("max_abs_err", "ms", "plain_ms", "bound_ms"),
            (timed[rows][0], timed[rows][2], timed[rows][3], timed[rows][4]))}
        if from_run:
            extra["from_run"] = from_run
        record(records, name, counter, "w4a8_gemv.cu", replaces, err, "1e-4*max|ref| + 1e-6",
               err / tol, ms, plain_ms, b_ms, b_by, None, cols=cols, L=L, IN=IN, OUT=OUT,
               launch_floor_ms=launch_floor_ms(), **extra)
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


def check_decode(dev, records, bits: int, need_attn: bool, C: int, i8dot: bool = False,
                 B: int = 1, from_run=None, tp: int = 1):
    """K3 (C = 2048, the main path's budget) or K5 (C = 32768, a full
    cache above the TPU's one-shot budget) at one (bits, need_attn), in the
    dequantizing branch or in the ``i8dot`` one (then also the dequantizing
    variant's time on the same inputs), over B lanes (``bench --batch``),
    at one tensor-parallel rank's heads (a tp-th of them) with ``tp``."""
    from cold_compress_tpu_torch.ops import decode_attn

    H, KVH, D = 32 // tp, 8 // tp, 128
    G = H // KVH
    gen = torch.Generator(device=dev).manual_seed(2 + bits + C + int(need_attn) + B + tp)
    counter = decode_attn.variant(bits, need_attn, i8dot)
    plain = (decode_attn.decode_attention_i8dot_plain if i8dot
             else decode_attn.decode_attention_plain)
    name = f"{counter}@C{C}" + (f"B{B}" if B > 1 else "") + (f"tp{tp}" if tp > 1 else "")
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

    # One device operation per call, the kernel: nothing before it (q is
    # bf16 already) and no cast after it (it writes q's dtype).
    nodes = graph_nodes_per_call(run)
    n_dev = sum(nodes.values())
    assert n_dev == 1 and own_and_torch(nodes, ("decode_attn_kernel",))[0] == {
        "decode_attn_kernel": 1}, f"{name}: device operations per call {dict(nodes)}"
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
        f"exactly {n_dev} device operation per call (graph nodes), clusters of {nc} CTAs")
    if i8dot:  # the i8dot branch of the one-shot kernel, and of the chunked step
        replaces = ("ops/pallas_decode_attn.py:172" if C <= 4096
                    else "ops/pallas_decode_attn.py:274")
    else:
        replaces = ("ops/pallas_decode_attn.py:899" if C <= 4096
                    else "ops/pallas_decode_attn.py:438")
    if from_run:
        extra["from_run"] = from_run
    record(records, name, counter, "decode_attn.cu", replaces, err, tol, ratio, ms, plain_ms,
           b_ms, b_by, library_ms, C=C, B=B, KVH=KVH, device_kernels_per_call=n_dev, cluster=nc,
           **extra)


def check_hh_evict(dev, records, B: int = 1, C: int = 2048):
    """K7 alone (the runs that evict without the fused insert: kv4, kv2 and
    bf16 heavy-hitter caches, an analysis cache's shadow) over B lanes of 8
    heads' C histories, each lane at its own position; at B = 1 also rows
    off a 16-byte boundary."""
    from cold_compress_tpu_torch.ops import evict

    H, g_tok, recent = 8, 4, 10
    gen = torch.Generator(device=dev).manual_seed(5 + B + C)
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
    # recent window, the first few are global tokens. Lane b is 2b later.
    ipos = (C + 3 + 2 * torch.arange(B, dtype=torch.int32, device=dev)).reshape(B, 1, 1)

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
    for Cm in ((2047, 301) if B == 1 else ()):
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
    shape = ("" if C == 2048 else f"C{C}") + ("" if B == 1 else f"B{B}")
    name = "hh_evict" + (f"@{shape}" if shape else "")
    log(f"[time] {name}: {ms:.4f} ms (bound {b_ms:.6f} ms by {b_by}), plain "
        f"{plain_ms:.4f} ms, library: none; launch floor {launch_floor_ms():.4f} ms")
    record(records, name, "hh_evict", "hh_evict.cu", "ops/pallas_evict.py:57", 0.0,
           "bit-equal", 0.0, ms, plain_ms, b_ms, b_by, None, B=B, C=C, H=H,
           launch_floor_ms=launch_floor_ms())


def check_hh_evict_insert(dev, records, B: int = 1, KVH: int = 8, G: int = 4, C: int = 2048,
                          from_run=None, tp: int = 1):
    """K7's fused rotate-and-insert (``hh_evict_insert``) over B lanes of a
    kv8 heavy-hitter cache of KVH heads of C slots, G queries a KV head,
    each lane at its own position, against its plain version on the same
    tensors (three steps, bit for bit in q, idx and every cache tensor),
    timed beside its bound and the plain version. The caches' even lanes
    have five empty slots, their positions are shuffled (global and recent
    slots anywhere). ``tp`` names a tensor-parallel rank's shape (KVH a
    tp-th of 8)."""
    from cold_compress_tpu_torch.caches import get_cache_strategy
    from cold_compress_tpu_torch.caches.base import CacheSpec, prefill_update
    from cold_compress_tpu_torch.models.rope import precompute_freqs_cis
    from cold_compress_tpu_torch.ops import evict

    H, D = KVH * G, 128
    gen = torch.Generator(device=dev).manual_seed(40 + B + C + KVH + G)
    spec = CacheSpec(cache_strategy="heavy_hitter", max_cache_length=C, max_seq_length=2 * C + 64,
                     global_tokens=4, recent_window=10, cache_bits=8)
    strat = get_cache_strategy("heavy_hitter")

    def new_state():
        s = strat.init(spec, B, KVH, D, device=dev)
        k, v = (torch.randn((B, KVH, C, D), device=dev, generator=gen).to(torch.bfloat16)
                for _ in range(2))
        perm = torch.stack([torch.randperm(C, device=dev, generator=gen) for _ in range(B * KVH)])
        fill = torch.tensor([C - 5 if b % 2 == 0 else C for b in range(B)], device=dev)
        valid = torch.arange(C, device=dev)[None, None, :] < fill[:, None, None]
        prefill_update(strat, s, perm.reshape(B, KVH, C).to(torch.int32), k, v,
                       valid.expand(B, KVH, C))
        s.extra["attn_num"].copy_(torch.randint(1, 40, (B, KVH, C), device=dev, generator=gen) / 4)
        s.extra["attn_denom"].copy_(torch.randint(0, 6, (B, KVH, C), device=dev, generator=gen))
        return s

    def copy_of(s):
        t = strat.init(spec, B, KVH, D, device=dev)
        for a, b in zip(t.tensors(), s.tensors()):
            a.copy_(b)
        return t

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else (
            t.view(torch.int16) if t.dtype == torch.bfloat16 else t)

    rope = precompute_freqs_cis(2 * C + 64, D, 1e6, device=dev)
    ipos = C + 5 * torch.arange(B, dtype=torch.int32, device=dev)
    freqs = rope[ipos.long()][:, None]
    y = (3 * torch.randn((B, 1, (H + 2 * KVH) * D), device=dev, generator=gen)).to(torch.bfloat16)
    card = new_state()
    plain = copy_of(card)
    same = True
    for step in range(3):
        q, idx = evict.hh_evict_insert(y, freqs, card, ipos + step, n_head=H, n_kv_head=KVH)
        q_ref, idx_ref = evict.hh_evict_insert_plain(y, freqs, plain, ipos + step, H, KVH)
        torch.cuda.synchronize()
        same = same and torch.equal(bits(q), bits(q_ref.contiguous())) and torch.equal(
            idx, idx_ref) and all(torch.equal(bits(a), bits(b))
                                  for a, b in zip(card.tensors(), plain.tensors()))
    log(f"[check] hh_evict_insert B={B} KVH={KVH} G={G} C={C}: q, idx and every cache "
        f"tensor bit-equal over 3 steps: {same}")
    assert same, "hh_evict_insert disagrees with its plain version"

    # Reads: num, denom and pos, the projection's row, the rope row, the
    # position; writes: q, two 128-byte rows, four side scalars, pos, mask,
    # num, denom, the count and idx.
    nbytes = (12 * B * KVH * C + 2 * D * B * (H + 2 * KVH) + 4 * D * B + 4 * B
              + 2 * D * B * H + B * KVH * (2 * D + 16 + 4 + 1 + 8 + 4 + 4))
    n = copies_for(12 * B * KVH * C)
    states = [card] + [copy_of(card) for _ in range(n - 1)]
    ms = time_ms(lambda i: evict.hh_evict_insert(y, freqs, states[i % n], ipos,
                                                 n_head=H, n_kv_head=KVH), 200)
    plain_ms = time_ms(lambda i: evict.hh_evict_insert_plain(y, freqs, states[i % n], ipos, H,
                                                             KVH), 20)
    b_ms, b_by = bound(nbytes, 4 * B * KVH * C, "bf16")
    shape = ("" if C == 2048 else f"C{C}") + ("" if B == 1 else f"B{B}") + (
        f"tp{tp}" if tp > 1 else "" if (KVH, G) == (8, 4) else f"KVH{KVH}G{G}")
    name = "hh_evict_insert" + (f"@{shape}" if shape else "")
    log(f"[time] {name}: {ms:.4f} ms (bound {b_ms:.6f} ms by {b_by}), plain "
        f"{plain_ms:.4f} ms, library: none; launch floor {launch_floor_ms():.4f} ms")
    extra = {"from_run": from_run} if from_run else {}
    record(records, name, "hh_evict_insert", "hh_evict.cu", "ops/pallas_evict.py:57", 0.0,
           "bit-equal", 0.0, ms, plain_ms, b_ms, b_by, None, B=B, C=C, H=KVH, G=G,
           launch_floor_ms=launch_floor_ms(), **extra)


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
    for L, row in by_rows.items():
        row["plain"] = time_ms(lambda i: qmm.w8a8_gemv_plain(row["x"], *layers[i % n]), 3, 1)
        row["lib"], lib_text = int_mm_ms(row["x"], layers, dev)
        log(f"[time] {name} L={L}: plain {row['plain']:.3f} ms, library {lib_text}")
    one, five = by_rows[1], by_rows[5]
    plain_ms, library_ms = one["plain"], one["lib"]
    record(records, name, name, "w8a8_gemv.cu", "ops/pallas_qmm.py:1293",
           max(one["err"], five["err"]), "bit-equal", 0.0, one["ms"], plain_ms, one["b_ms"],
           one["b_by"], library_ms, cols=one["cols"], after_small_ms=one["cold"],
           ms_l5=five["ms"], bound_ms_l5=five["b_ms"], cols_l5=five["cols"],
           after_small_ms_l5=five["cold"], plain_ms_l5=five["plain"], library_ms_l5=five["lib"],
           launch_floor_ms=launch_floor_ms())
    del layers


def int_mm_ms(x, layers, dev):
    """(ms, text) of the library's int8 GEMM for K9's function on x's rows
    over the weight copies ``layers``: cuBLASLt takes at least 17 rows, so
    the activations are quantized and padded to 32 rows beforehand, then
    ``torch._int_mm`` and the two scalings; None where the call fails."""
    from cold_compress_tpu_torch.ops import qmm

    L, IN = x.shape
    xq, sx = qmm.quantize_activations(x)
    xq32 = torch.zeros((32, IN), dtype=torch.int8, device=dev)
    xq32[:L] = xq.to(torch.int8)
    sx32 = torch.ones((32, 1), device=dev)
    sx32[:L] = sx

    def lib(i):
        wt_i, st_i = layers[i % len(layers)]
        return (torch._int_mm(xq32, wt_i.t()).float() * st_i) * sx32

    try:
        same = torch.equal(lib(0)[:L], qmm.w8a8_gemv_plain(x, *layers[0]))
        ms = time_ms(lib, 50)
    except RuntimeError as e:  # the library call is a yardstick, not a check
        return None, f"none (torch._int_mm failed: {e})"
    return ms, (f"{ms:.4f} ms (torch._int_mm on 32 padded rows plus scaling, bit-equal to "
                f"the plain version: {same})")


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


def prefill_nodes(name: str, fn, summaries: bool = True) -> tuple:
    """(device operations, the kernel's, PyTorch's) of one K4/K6 call, from
    its captured graph: exactly one launch of each pass kernel (pass 2 and
    its reduction only with ``summaries``), the rest PyTorch's own kernels
    (the lengths' fill, the summaries' means), and nothing else."""
    nodes = graph_nodes_per_call(fn)
    mine, n_torch, other = own_and_torch(nodes, PREFILL_KERNELS)
    want = {k: int(summaries or k == "flash_fwd_kernel") for k in PREFILL_KERNELS}
    assert mine == want and not other, f"{name}: device operations per call {dict(nodes)}"
    return sum(nodes.values()), sum(mine.values()), n_torch


def pass_times(q, k, v, plen: int, windows=None):
    """ms of K4's (or, with ``windows``, K6's) pass 1 alone and of pass 2
    with its reduction alone, on the same inputs."""
    from cold_compress_tpu_torch.ops import prefill_attn

    plen_t = torch.as_tensor(plen, dtype=torch.int32, device=q.device).expand(q.shape[0])
    plen_t = plen_t.contiguous()
    _, mbuf, ilbuf = prefill_attn.flash_pass1(q, k, v)
    pass1 = time_ms(lambda i: prefill_attn.flash_pass1(q, k, v), 5, 1)
    pass2 = time_ms(lambda i: prefill_attn.flash_pass2(q, k, mbuf, ilbuf, plen_t,
                                                       window_lens=windows), 5, 1)
    return pass1, pass2


def check_flash_prefill(dev, records, plens=(7928,), from_run=None):
    """K4 at the main path's bucket, one lane per prompt length in
    ``plens`` (``bench --batch``: lane b's prompt is 8 b tokens shorter),
    y and each lane's summaries against the plain version."""
    from cold_compress_tpu_torch.ops import prefill_attn

    B, H, KVH, P, D = len(plens), 32, 8, 8192, 128
    plen = plens[0] if B == 1 else torch.tensor(plens, dtype=torch.int32, device=dev)
    name = "flash_prefill_summary" + (f"@B{B}" if B > 1 else "")
    gen = torch.Generator(device=dev).manual_seed(3 + B)
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
    ok = ratio <= 1
    for b, pl in enumerate(plens):  # each lane's summaries against its own scale
        errs = {key: max_err(summ[key][b], ref_summ[key][b]) for key in ("obs_mean", "cum_mean")}
        tols = {key: 1e-4 * float(ref_summ[key][b].abs().max()) + 1e-7 for key in errs}
        log(f"[check] {name} P={P} lane {b} prompt_len={pl}: y max_abs_err={err:.3e}, "
            f"max err/tol {ratio:.3f} (tol {tol}); "
            + "; ".join(f"{k} max_abs_err={e:.3e} tol={tols[k]:.3e}" for k, e in errs.items()))
        ok = ok and all(errs[k] <= tols[k] for k in errs)
        assert float(summ["cum_mean"][b, :, pl:].abs().max()) == 0.0, name
        assert float(summ["cum_mean"][b, :, :pl].abs().max()) > 0.0, name
    assert ok, f"{name} disagrees with its plain version"

    ms = time_ms(lambda i: prefill_attn.flash_prefill(q, k, v, plen, need_summary=True), 5, 1)
    pass1_ms, pass2_ms = pass_times(q, k, v, plen)
    n_dev, n_own, n_torch = prefill_nodes(
        name, lambda i: prefill_attn.flash_prefill(q, k, v, plen, need_summary=True))
    plain_ms = time_ms(lambda i: prefill_attn.flash_prefill_plain(q, k, v, plen), 2, 1)
    nbytes = 2 * (2 * B * H * P * D + 2 * B * KVH * P * D) + 2 * 4 * B * KVH * P
    pairs = B * H * P * (P + 1) // 2  # causal (query, key) pairs
    b_ms, b_by = bound(nbytes, 4 * D * pairs, "bf16")
    kr = k.repeat_interleave(H // KVH, dim=1)
    vr = v.repeat_interleave(H // KVH, dim=1)
    sdpa_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, is_causal=True), 5, 1)
    log(f"[time] {name}: {ms:.3f} ms (pass 1 {pass1_ms:.3f}, pass 2 and its "
        f"reduction {pass2_ms:.3f}; bound {b_ms:.3f} ms by {b_by}; "
        f"{4 * D * pairs / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, library: none "
        f"(scaled_dot_product_attention, causal y only, no summaries: {sdpa_ms:.3f} ms); "
        f"exactly {n_dev} device operations per call (graph nodes): {n_own} the kernel's, "
        f"{n_torch} PyTorch's (the lengths' fill, the summaries' means)")
    extra = {"from_run": from_run} if from_run else {}
    record(records, name, "flash_prefill_summary", "flash_prefill.cu",
           "ops/pallas_prefill.py:167", err, tol, ratio, ms, plain_ms, b_ms, b_by, None,
           B=B, pass1_ms=pass1_ms, pass2_ms=pass2_ms, device_kernels_per_call=n_dev,
           own_kernels_per_call=n_own, torch_kernels_per_call=n_torch,
           sdpa_causal_y_ms=sdpa_ms, **extra)


GPTQ_RUN = "quantize --mode int4-gptq (Llama-3-8B, 10 x 512 calibration tokens)"
GPTQ_GEN_RUN = "generate CLI (int4-gptq checkpoint, heavy_hitter kv8)"
#: GPTQ's calibration: sequences, tokens each, group size (root quantize.py's).
GPTQ_SAMPLES, GPTQ_SEQ, GPTQ_GROUP = 10, 512, 128


def check_flash_prefill_calibration(dev, records):
    """K4 at GPTQ's calibration shape (B = 10 sequences of P = 512, every
    key valid, no summaries): y against the plain version, bit-equal
    across two calls, one pass kernel per call, beside SDPA (the same
    function: causal GQA attention alone)."""
    from cold_compress_tpu_torch.ops import prefill_attn

    B, H, KVH, P, D = GPTQ_SAMPLES, 32, 8, GPTQ_SEQ, 128
    name = f"flash_prefill@B{B}P{P}"
    gen = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((B, H, P, D), device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn((B, KVH, P, D), device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn((B, KVH, P, D), device=dev, generator=gen).to(torch.bfloat16)

    def run(i):
        return prefill_attn.flash_prefill(q, k, v, P, need_summary=False)

    y, summ = run(0)
    assert summ is None and torch.equal(y, run(0)[0]), f"{name}: two calls differ"
    ref_y, _ = prefill_attn.flash_prefill_plain(q, k, v, P, need_summary=False)
    torch.cuda.synchronize()
    err, ratio, tol = bf16_out_err(y, ref_y, 2**-7)  # as K4's check at P = 8192
    log(f"[check] {name}: y max_abs_err={err:.3e}, max err/tol {ratio:.3f} (tol {tol})")
    assert ratio <= 1 and bool(torch.isfinite(y).all()), f"{name} disagrees with its plain version"
    n_dev, n_own, n_torch = prefill_nodes(name, run, summaries=False)
    ms = time_ms(run, 20)
    plain_ms = time_ms(lambda i: prefill_attn.flash_prefill_plain(q, k, v, P, need_summary=False),
                       3, 1)
    library_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    nbytes = 2 * (2 * B * H * P * D + 2 * B * KVH * P * D)  # q, y, k, v in bf16
    pairs = B * H * P * (P + 1) // 2
    b_ms, b_by = bound(nbytes, 4 * D * pairs, "bf16")
    log(f"[time] {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
        f"{4 * D * pairs / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, library "
        f"{library_ms:.4f} ms (scaled_dot_product_attention, causal, enable_gqa); exactly "
        f"{n_dev} device operations per call: {n_own} the kernel's, {n_torch} PyTorch's")
    record(records, name, "flash_prefill_summary", "flash_prefill.cu",
           "ops/pallas_prefill.py:167", err, tol, ratio, ms, plain_ms, b_ms, b_by, library_ms,
           B=B, P=P, device_kernels_per_call=n_dev, own_kernels_per_call=n_own,
           torch_kernels_per_call=n_torch, from_run=GPTQ_RUN)


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
    n_dev, n_own, n_torch = prefill_nodes(
        name, lambda i: prefill_attn.flash_profile(q, k, v, plen, window_lens=windows))
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
        f"exactly {n_dev} device operations per call (graph nodes): {n_own} the kernel's, "
        f"{n_torch} PyTorch's")
    record(records, name, "flash_profile", "flash_prefill.cu", "ops/pallas_prefill.py:281",
           err, tol, ratio, ms, plain_ms, b_ms, b_by, None, windows=list(windows),
           pass1_ms=pass1_ms, pass2_ms=pass2_ms, device_kernels_per_call=n_dev,
           own_kernels_per_call=n_own, torch_kernels_per_call=n_torch, sdpa_causal_y_ms=sdpa_ms)


#: The query blocks of the sequence- and pipeline-parallel prefills at the
#: main path's bucket (P = 8192, prompt 7928): sp = 2's two shards and the
#: last (busiest) shard of sp = 4 (against all 8192 keys), and two of the
#: pipeline's 64-row chunks, each against the keys up to its last row: one
#: mid-prompt (its keys end before the prompt does) and the last.
PARTIAL_BLOCKS = ((4096, 0, 2), (4096, 4096, 2), (2048, 6144, 4))
PP_CHUNK = 64
PP_CHUNK_OFFSETS = (4096, 8192 - PP_CHUNK)
#: The JAX package's functions that K4's and K6's query-block forms
#: compute (XLA code there, which the TPU kernels of the same functions,
#: pallas_prefill.py:167 and :281, do not take).
PARTIAL_IMPLEMENTS = {"flash_prefill_partial": "ops/attention.py:175 (chunked_prefill_partial)",
                      "flash_profile_partial": "caches/hybrid.py:575 (_profile_partial)"}


def partial_inputs(dev, seed: int, Pq: int, Pk: int = 8192):
    B, H, KVH, D = 1, 32, 8, 128
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, Pq, D), device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn((B, KVH, Pk, D), device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn((B, KVH, Pk, D), device=dev, generator=gen).to(torch.bfloat16)
    return q, k, v


def partial_bound(q, k, q_offset: int, n_sums: int):
    """(bound ms, by, causal pairs) of a query block: QK^T and PV over the
    (row, key) pairs its rows see, against q and y, the K/V rows it reads
    (keys up to its last row) and its f32 sums over every key."""
    B, H, Pq, D = q.shape
    KVH, Pk = k.shape[1], k.shape[2]
    seen = min(Pk, q_offset + Pq)
    pairs = B * H * (Pq * q_offset + Pq * (Pq + 1) // 2)
    nbytes = 2 * (2 * B * H * Pq * D + 2 * B * KVH * seen * D) + 4 * n_sums * B * KVH * Pk
    b_ms, b_by = bound(nbytes, 4 * D * pairs, "bf16")
    return b_ms, b_by, pairs


def masked_sdpa_ms(q, k, v, q_offset: int):
    """(ms, y) of ``scaled_dot_product_attention`` with the block's causal
    mask by global position: the same y, no summaries."""
    Pq, Pk = q.shape[2], k.shape[2]
    keys = torch.arange(Pk, device=q.device)
    mask = keys[None, :] <= (q_offset + torch.arange(Pq, device=q.device))[:, None]

    def run(i=0):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                enable_gqa=True)
    return time_ms(run, 5, 1), run()


def check_flash_prefill_partial(dev, records, Pq: int, q_offset: int, from_run: str,
                                Pk: int = 8192, plen: int = 7928):
    """K4 over a block of ``Pq`` query rows at ``q_offset`` against ``Pk``
    keys of the main path's prompt: y and the raw sums against the plain
    version (``chunked_prefill_partial`` on the card), zeros past the
    block's last row, bit-equal across two calls, its device operations
    exactly."""
    from cold_compress_tpu_torch.ops import prefill_attn
    from cold_compress_tpu_torch.ops.attention import chunked_prefill_partial

    name = f"flash_prefill_partial@{Pq}+{q_offset}" + (f"/{Pk}" if Pk != 8192 else "")
    q, k, v = partial_inputs(dev, 13 + q_offset // 64, Pq, Pk)

    def run(i=0):
        return prefill_attn.flash_prefill_partial(q, k, v, plen, q_offset=q_offset)

    y, cum, obs = run()
    y2, cum2, obs2 = run()
    assert torch.equal(y, y2) and torch.equal(cum, cum2) and torch.equal(obs, obs2), \
        f"{name}: two calls on the same inputs differ"
    del y2, cum2, obs2
    ry, rcum, robs = chunked_prefill_partial(q, k, v, plen, q_offset=q_offset,
                                             need_summary=True)
    torch.cuda.synchronize()
    err, ratio, tol = bf16_out_err(y, ry, 2**-7)  # as K4's check
    errs = {"cum": max_err(cum, rcum), "obs": max_err(obs, robs)}
    tols = {"cum": 1e-4 * float(rcum.abs().max()) + 1e-7,
            "obs": 1e-4 * float(robs.abs().max()) + 1e-7}
    log(f"[check] {name} (Pk={Pk}, prompt_len={plen}): y max_abs_err={err:.3e}, max err/tol "
        f"{ratio:.3f} (tol {tol}); " + "; ".join(
            f"{key} max_abs_err={e:.3e} tol={tols[key]:.3e}" for key, e in errs.items()))
    assert ratio <= 1 and all(errs[key] <= tols[key] for key in errs), \
        f"{name} disagrees with its plain version"
    assert not bool(cum[..., q_offset + Pq:].any()), name
    del ry, rcum, robs
    ms = time_ms(run, 5, 1)
    n_dev, n_own, n_torch = prefill_nodes(name, run)
    plain_ms = time_ms(lambda i: chunked_prefill_partial(q, k, v, plen, q_offset=q_offset,
                                                         need_summary=True), 2, 1)
    sdpa_ms, sdpa_y = masked_sdpa_ms(q, k, v, q_offset)
    sdpa_err = max_err(sdpa_y, y)
    b_ms, b_by, pairs = partial_bound(q, k, q_offset, 2)
    log(f"[time] {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
        f"{4 * 128 * pairs / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, library: none "
        f"(scaled_dot_product_attention with the block's mask, y only, no summaries: "
        f"{sdpa_ms:.4f} ms, y within {sdpa_err:.3e}); exactly {n_dev} device operations per call: "
        f"{n_own} the kernel's, {n_torch} PyTorch's")
    record(records, name, "flash_prefill_partial", "flash_prefill.cu",
           "ops/pallas_prefill.py:167", err, tol, ratio, ms, plain_ms, b_ms, b_by, None,
           implements=f"{REPO_TPU}/{PARTIAL_IMPLEMENTS['flash_prefill_partial']}", Pq=Pq,
           q_offset=q_offset, Pk=Pk, device_kernels_per_call=n_dev,
           own_kernels_per_call=n_own, torch_kernels_per_call=n_torch,
           sdpa_masked_y_ms=sdpa_ms, from_run=from_run)


def check_flash_profile_partial(dev, records, windows, from_run: str, Pq: int = 4096,
                                q_offset: int = 4096, plen: int = 7928):
    """K6 over sp = 2's second query block (hybrid under sp = 2): y, cum
    and the window sums against the plain version, its device operations
    exactly."""
    from cold_compress_tpu_torch.ops import prefill_attn
    from cold_compress_tpu_torch.ops.attention import chunked_prefill_partial

    name = f"flash_profile_partial.w{len(windows)}@{Pq}+{q_offset}"
    q, k, v = partial_inputs(dev, 29 + len(windows), Pq)

    def run(i=0):
        return prefill_attn.flash_profile_partial(q, k, v, plen, windows, q_offset=q_offset)

    def plain(i=0):
        y, _, _ = chunked_prefill_partial(q, k, v, plen, q_offset=q_offset)
        return (y, *prefill_attn.profile_partial(q, k, plen, windows, q_offset=q_offset))

    y, cum, wcols = run()
    ry, rcum, rw = plain()
    torch.cuda.synchronize()
    err, ratio, tol = bf16_out_err(y, ry, 2**-7)
    errs = {"cum": max_err(cum, rcum), "wcols": max_err(wcols, rw)}
    tols = {"cum": 1e-4 * float(rcum.abs().max()), "wcols": 1e-4 * float(rw.abs().max())}
    log(f"[check] {name} windows={windows}: y max_abs_err={err:.3e}, max err/tol {ratio:.3f} "
        f"(tol {tol}); " + "; ".join(f"{key} max_abs_err={e:.3e} tol={tols[key]:.3e}"
                                     for key, e in errs.items()))
    assert ratio <= 1 and all(errs[key] <= tols[key] for key in errs), \
        f"{name} disagrees with its plain version"
    del ry, rcum, rw
    ms = time_ms(run, 5, 1)
    n_dev, n_own, n_torch = prefill_nodes(name, run)
    plain_ms = time_ms(plain, 1, 1)
    b_ms, b_by, pairs = partial_bound(q, k, q_offset, 1 + len(windows))
    log(f"[time] {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}), plain {plain_ms:.3f} ms, "
        f"library: none; exactly {n_dev} device operations per call: {n_own} the kernel's, "
        f"{n_torch} PyTorch's")
    record(records, name, "flash_profile_partial", "flash_prefill.cu",
           "ops/pallas_prefill.py:281", err, tol, ratio, ms, plain_ms, b_ms, b_by, None,
           implements=f"{REPO_TPU}/{PARTIAL_IMPLEMENTS['flash_profile_partial']}",
           windows=list(windows), Pq=Pq, q_offset=q_offset, Pk=8192, device_kernels_per_call=n_dev,
           own_kernels_per_call=n_own, torch_kernels_per_call=n_torch, from_run=from_run)


def check_partial_offset0_bit_equal(dev, plen: int = 7928):
    """At ``q_offset = 0`` with as many rows as keys, K4's and K6's
    query-block forms return exactly what K4 and K6 return: y, and the raw
    sums behind K4's summary means."""
    from cold_compress_tpu_torch.ops import prefill_attn
    from cold_compress_tpu_torch.ops.attention import finalize_summary

    q, k, v = partial_inputs(dev, 41, 8192)
    y, cum, obs = prefill_attn.flash_prefill_partial(q, k, v, plen)
    y0, summ0 = prefill_attn.flash_prefill(q, k, v, plen)
    plen_t = torch.full((1,), plen, dtype=torch.int32, device=dev)
    summ = finalize_summary(cum, obs, plen_t, 8192, 16)
    assert torch.equal(y, y0) and all(torch.equal(summ[key], summ0[key]) for key in summ0), \
        "flash_prefill_partial at q_offset 0 differs from flash_prefill"
    for windows in ((2457,), (819, 2457)):
        got = prefill_attn.flash_profile_partial(q, k, v, plen, windows)
        want = prefill_attn.flash_profile(q, k, v, plen, windows)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            f"flash_profile_partial at q_offset 0 differs from flash_profile ({windows})"
    log("[check] flash_prefill_partial and flash_profile_partial (1 and 2 windows) at "
        "q_offset 0, Pq = Pk = 8192: bit-equal to flash_prefill (y, summaries) and "
        "flash_profile (y, cum, wcols)")


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
# Phase 2, Mellum2-12B-A2.5B: the grouped expert GEMV, K4's window entry and
# K7's ring insert at its shapes
# ---------------------------------------------------------------------------

#: Mellum2-12B-A2.5B's expert layer (dim, expert width, experts, top k, int4
#: group size) and attention (query heads, KV heads, window).
M2 = dict(D=2304, F=896, E=64, K=8, gs=128, H=32, KVH=4, W=1024)
M2_NAME, M2_LANES = "Mellum2-12B-A2.5B", 4
M2_RUN = f"{M2_NAME} generate_batch ({M2_LANES} lanes, kv8 heavy_hitter C 2048, 1024-slot rings)"
MOE_KERNELS = ("moe_w4a8_gemv_kernel",)


def m2_experts(dev, gen):
    """One layer's 64 random int4 experts in the grouped GEMV's layout."""
    from cold_compress_tpu_torch.ops import moe

    D, F, gs = M2["D"], M2["F"], M2["gs"]

    def leaf(IN, OUT):
        w = torch.randint(-128, 128, (IN // 2, OUT), dtype=torch.int8, device=dev, generator=gen)
        s = torch.rand((IN // gs, OUT), device=dev, generator=gen) * 3e-3 + 1e-3
        z = s * torch.rand((IN // gs, OUT), device=dev, generator=gen)
        return {"w": w, "scales": s.to(torch.bfloat16), "zeros": z.to(torch.bfloat16),
                "group_size": gs}

    return moe.MoEWeights.from_experts([{"w1": leaf(D, F), "w3": leaf(D, F), "w2": leaf(F, D)}
                                        for _ in range(M2["E"])])


def m2_ids(dev, gen, B: int):
    """B lanes' top-8 expert ids of 64 (distinct within a lane), every lane
    after the first taking lane 0's first three."""
    E, K = M2["E"], M2["K"]
    ids = [torch.randperm(E, device=dev, generator=gen)[:K].tolist()]
    for _ in range(1, B):
        rest = [e for e in torch.randperm(E, device=dev, generator=gen).tolist()
                if e not in ids[0][:3]]
        ids.append(ids[0][:3] + rest[:K - 3])
    return torch.tensor(ids, dtype=torch.long, device=dev)


def check_moe_gemv(dev, records, B: int):
    """The grouped expert GEMV (``ops/moe.py::moe_decode``: gate and up with
    SwiGLU, then down with the weighted combine) at Mellum2's widths, B
    lanes of top 8 of 64 experts, every lane after the first sharing three
    of lane 0's experts (at B = 16 in two groups of 8 lanes, a launch pair
    each): against ``moe_decode_plain`` (K1's plain function per pair), the
    layer's counter up by each group's distinct experts, the same bits
    twice, exactly two kernels per group a call (graph nodes), timed over
    id sets that move the experts read from call to call (each distinct
    expert's leaves then come from device memory), beside the bound of the
    bytes of the experts the groups read."""
    from cold_compress_tpu_torch.ops import moe

    D, F, E, K = M2["D"], M2["F"], M2["E"], M2["K"]
    gen = torch.Generator(device=dev).manual_seed(60 + B)
    mw = m2_experts(dev, gen)
    x = torch.randn((B, D), device=dev, generator=gen).to(torch.bfloat16)
    ids = m2_ids(dev, gen, B)
    wts = torch.softmax(torch.randn((B, K), device=dev, generator=gen), -1)
    arrive = moe.arrive_buffer(D, dev)
    layer = 0
    groups = range(0, B, moe.MAX_LANES)

    def read(ids):  # the experts the groups read
        return sum(len(set(ids[g:g + moe.MAX_LANES].reshape(-1).tolist())) for g in groups)

    distinct = read(ids)
    c0 = int(moe.expert_counter(dev)[layer])
    y = moe.moe_decode(x, ids, wts, mw, layer=layer, arrive=arrive)
    counted = int(moe.expert_counter(dev)[layer]) - c0
    ref = moe.moe_decode_plain(x, ids, wts, mw)
    torch.cuda.synchronize()
    # Exact int8 x int4 group dots on both sides; the f32 order of the group
    # terms differs, so a gate or up result can round one bf16 unit apart
    # before SwiGLU, and the down product over 896 inputs carries that: one
    # bf16 unit of the element plus 2**-6 of the row's largest
    # (tests/test_torch_mellum2.py holds the same).
    err, ratio, tol = bf16_out_err(y, ref, 2**-6)
    same = torch.equal(y, moe.moe_decode(x, ids, wts, mw, layer=layer, arrive=arrive))
    rows_max = max(collections.Counter(ids.reshape(-1).tolist()).values())
    name = "moe_gemv" + (f"@L{B}" if B > 1 else "")
    log(f"[check] {name} D={D} F={F} E={E} K={K} B={B}: {distinct} experts read (counter "
        f"{counted}), at most {rows_max} lanes on one; max_abs_err={err:.3e}, max err/tol "
        f"{ratio:.3f} (tol {tol}); two calls bit-equal {same}; arrival buffer zero "
        f"{int(arrive.abs().sum()) == 0}")
    assert ratio <= 1, f"{name}: the kernels disagree with the plain version"
    assert same and counted == distinct and int(arrive.abs().sum()) == 0, name
    nodes = graph_nodes_per_call(lambda i: moe.moe_decode(x, ids, wts, mw, layer=layer,
                                                          arrive=arrive))
    mine, n_torch, other = own_and_torch(nodes, MOE_KERNELS)
    assert mine == {"moe_w4a8_gemv_kernel": 2 * len(groups)} and n_torch == 0 and not other, \
        f"{name}: device operations per call {dict(nodes)}"

    # Id sets for timing: at B = 1 eight disjoint sets cover the 64 experts;
    # at larger B fresh draws, each with lane 0's three shared.
    n = 8
    if B == 1:
        perm = torch.randperm(E, device=dev, generator=gen)
        sets = [perm[K * i:K * (i + 1)][None].contiguous() for i in range(n)]
    else:
        sets = [m2_ids(dev, gen, B) for _ in range(n)]
    per = [read(s) for s in sets]
    ms = time_ms(lambda i: moe.moe_decode(x, sets[i % n], wts, mw, layer=layer, arrive=arrive),
                 64)
    plain_ms = time_ms(lambda i: moe.moe_decode_plain(x, sets[i % n], wts, mw), 2, 1)
    expert_bytes = sum(t[0].numel() * t.element_size() for t in mw.tensors())
    mean_distinct = sum(per) / n
    # Each distinct expert's leaves once; x, ids and weights, h written and
    # read, the down rows' f32 workspace written and read, out.
    nbytes = (mean_distinct * expert_bytes + 2 * B * D + 12 * B * K + 2 * 2 * B * K * F
              + 2 * 4 * B * K * D + 2 * B * D)
    b_ms, b_by = bound(nbytes, 2 * B * K * 3 * D * F, "int8")
    log(f"[time] {name}: {ms:.4f} ms for both launches (bound {b_ms:.4f} ms by {b_by}: "
        f"{mean_distinct:.2f} experts of {expert_bytes} bytes read a call; "
        f"{nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms, library: none; "
        f"launch floor {launch_floor_ms():.4f} ms")
    record(records, name, "moe_gemv.w13", "moe_gemv.cu", None, err, tol, ratio, ms, plain_ms,
           b_ms, b_by, None, B=B, D=D, F=F, E=E, K=K, experts_read=mean_distinct,
           expert_bytes=expert_bytes, device_kernels_per_call=sum(nodes.values()),
           launch_floor_ms=launch_floor_ms(), from_run=M2_RUN)
    del mw


MOE_GEMM_KERNELS = ("moe_gemm_kernel", "moe_combine_kernel")


def check_moe_gemm(dev, records, N: int):
    """The expert layer's prefill (``ops/moe.py::moe_prefill``) at
    Mellum2's widths over N rows (the cell's four lanes of a call), top 8 of
    64 experts by a random router: against ``moe_prefill_plain``, the same
    bits twice, a captured call holding exactly the two grouped GEMM
    launches and the combine beside PyTorch's dispatch ops (no matmul), then
    each launch timed alone beside its bound (the GEMMs by bf16 operations,
    the combine by bytes), its plain version, and, for the GEMMs, a
    per-expert cuBLAS loop over the same sorted rows and weights dequantized
    beforehand (each expert's rows padded to 256, as the layer ran before)."""
    from cold_compress_tpu_torch.ops import moe, qmm

    D, F, E, K = M2["D"], M2["F"], M2["E"], M2["K"]
    gen = torch.Generator(device=dev).manual_seed(70 + N)
    mw = m2_experts(dev, gen)
    x = torch.randn((N, D), device=dev, generator=gen).to(torch.bfloat16)
    logits = torch.randn((N, E), device=dev, generator=gen)
    wts, ids = torch.topk(torch.softmax(logits, -1), K, dim=-1)
    wts = wts / wts.sum(-1, keepdim=True)
    y = moe.moe_prefill(x, ids, wts, mw)
    ref = moe.moe_prefill_plain(x, ids, wts, mw)
    torch.cuda.synchronize()
    # Only each f32 sum's order differs (wgmma against cuBLAS): a gate or up
    # product can round one bf16 unit apart before SwiGLU, and the down
    # product carries that h unit as a share of one term.
    err, ratio, tol = bf16_out_err(y, ref, 2**-8)
    same = torch.equal(y, moe.moe_prefill(x, ids, wts, mw))
    name = f"moe_gemm@N{N}"
    log(f"[check] {name} D={D} F={F} E={E} K={K}: max_abs_err={err:.3e}, max err/tol "
        f"{ratio:.3f} (tol {tol}); two calls bit-equal {same}")
    assert ratio <= 1, f"{name}: the kernels disagree with the plain version"
    assert same, name
    nodes = graph_nodes_per_call(lambda i: moe.moe_prefill(x, ids, wts, mw))
    mine, n_torch, other = own_and_torch(nodes, MOE_GEMM_KERNELS)
    # The dispatch's sort runs PyTorch's cub kernels (and their memsets);
    # no matmul kernel may run.
    mm = {n: c for n, c in other.items()
          if any(k in n.lower() for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas"))}
    assert mine == {"moe_gemm_kernel": 2, "moe_combine_kernel": 1} and not mm, \
        f"{name}: device operations per call {dict(nodes)}"
    log(f"[check] {name}: a captured call runs {mine}, {n_torch} of PyTorch's own kernels and "
        f"{sum(other.values())} other operations (cub's sort, memsets, copies), no matmul")
    del ref

    sched = moe.dispatch(ids, E)
    h = torch.empty((N * K, F), dtype=torch.bfloat16, device=dev)
    ys = torch.empty((N * K, D), dtype=torch.bfloat16, device=dev)
    moe.moe_gemm(x, sched.src, sched.tiles, mw.w13, mw.sz13, mw.gs13, h, swiglu=True)
    moe.moe_gemm(h, sched.pair, sched.tiles, mw.w2, mw.sz2, mw.gs2, ys, swiglu=False)
    yv = ys.view(N, K, D)
    t = {"dispatch": time_ms(lambda i: moe.dispatch(ids, E), 8),
         "w13": time_ms(lambda i: moe.moe_gemm(x, sched.src, sched.tiles, mw.w13, mw.sz13,
                                                mw.gs13, h, swiglu=True), 8),
         "w2": time_ms(lambda i: moe.moe_gemm(h, sched.pair, sched.tiles, mw.w2, mw.sz2,
                                               mw.gs2, ys, swiglu=False), 8),
         "combine": time_ms(lambda i: moe.moe_combine(yv, wts), 8),
         "layer": time_ms(lambda i: moe.moe_prefill(x, ids, wts, mw), 4)}
    plain = {"w13": time_ms(lambda i: moe.moe_gemm_plain(
                 x, sched.src, sched.tiles, mw.w13, mw.sz13, mw.gs13, h, swiglu=True), 1, 1),
             "w2": time_ms(lambda i: moe.moe_gemm_plain(
                 h, sched.pair, sched.tiles, mw.w2, mw.sz2, mw.gs2, ys, swiglu=False), 1, 1),
             "combine": time_ms(lambda i: moe.combine(yv, wts), 2, 1),
             "layer": time_ms(lambda i: moe.moe_prefill_plain(x, ids, wts, mw), 1, 1)}
    # The yardstick: cuBLAS over the same sorted rows, weights dequantized
    # beforehand, each expert's rows padded to 256 (one plan per size).
    counts = torch.bincount(ids.reshape(-1), minlength=E).tolist()
    offsets = [0]
    for c in counts:
        offsets.append(offsets[-1] + -(-c // 256) * 256)
    xs = x.index_select(0, sched.src.long())
    xs = torch.cat([xs, xs[:offsets[-1] - N * K]])  # padding rows, not read
    hs = torch.cat([h, h[:offsets[-1] - N * K]])
    w13d = qmm.dequantize_gemv(mw.w13, mw.sz13, mw.gs13)
    w2d = qmm.dequantize_gemv(mw.w2, mw.sz2, mw.gs2)
    gu = torch.empty((offsets[-1], 2 * F), dtype=torch.bfloat16, device=dev)
    yl = torch.empty((offsets[-1], D), dtype=torch.bfloat16, device=dev)

    def loop(a, w, out):
        for e in range(E):
            if offsets[e + 1] > offsets[e]:
                torch.matmul(a[offsets[e]:offsets[e + 1]], w[e], out=out[offsets[e]:offsets[e + 1]])

    lib = {"w13": time_ms(lambda i: loop(xs, w13d, gu), 4),
           "w2": time_ms(lambda i: loop(hs, w2d, yl), 4)}
    del xs, hs, w13d, w2d, gu, yl
    ex13 = sum(t_.numel() * t_.element_size() for t_ in (mw.w13, mw.sz13))
    ex2 = sum(t_.numel() * t_.element_size() for t_ in (mw.w2, mw.sz2))
    work = {"w13": (2 * N * D + ex13 + 2 * N * K * F + 4 * N * K, 2 * N * K * D * 2 * F, "bf16"),
            "w2": (2 * N * K * F + ex2 + 2 * N * K * D + 4 * N * K, 2 * N * K * F * D, "bf16"),
            "combine": (2 * N * K * D + 4 * N * K + 2 * N * D, N * K * D * 2, "bf16")}
    for part, counter in (("w13", "moe_gemm.w13"), ("w2", "moe_gemm.w2"),
                          ("combine", "moe_combine")):
        b_ms, b_by = bound(*work[part])
        lib_ms = lib.get(part)
        log(f"[time] {name} {part}: {t[part]:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"{100 * b_ms / t[part]:.1f}%; {work[part][1] / t[part] / 1e9:.1f} TFLOP/s), plain "
            f"{plain[part]:.3f} ms, library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}")
        record(records, f"{counter}@N{N}", counter, "moe_gemm.cu", None, err, tol, ratio,
               t[part], plain[part], b_ms, b_by, lib_ms, N=N, D=D, F=F, E=E, K=K,
               from_run=M2_RUN)
    b_all = sum(bound(*work[p])[0] for p in work)
    log(f"[time] {name} layer: {t['layer']:.4f} ms (dispatch {t['dispatch']:.4f} ms; the three "
        f"bounds {b_all:.4f} ms), plain {plain['layer']:.3f} ms; "
        f"x 28 layers: {28 * t['layer']:.1f} ms a call")
    del mw


def check_flash_prefill_window(dev, records, B: int = M2_LANES, P: int = 16384,
                               plen: int = 16256):
    """K4's window entry (``flash_prefill_window``) at the Mellum2 cell's
    long call: B lanes of a ``plen``-token prompt in a P-row bucket, 32
    query heads over 4 KV heads, a 1024-key window; y against the plain
    version (``chunked_prefill_partial`` with the window) on the prompt's
    rows, the same bits twice, one kernel per call (graph nodes), timed
    beside its bound (the window's (query, key) pairs) and beside K4's
    causal pass 1 on the same inputs."""
    from cold_compress_tpu_torch.ops import prefill_attn
    from cold_compress_tpu_torch.ops.attention import chunked_prefill_partial

    H, KVH, W, D = M2["H"], M2["KVH"], M2["W"], 128
    gen = torch.Generator(device=dev).manual_seed(70 + B)
    q = torch.randn((B, H, P, D), device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn((B, KVH, P, D), device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn((B, KVH, P, D), device=dev, generator=gen).to(torch.bfloat16)
    y = prefill_attn.flash_prefill_window(q, k, v, W)
    same = torch.equal(y, prefill_attn.flash_prefill_window(q, k, v, W))
    ref, _, _ = chunked_prefill_partial(q, k, v, plen, window=W)
    torch.cuda.synchronize()
    # As K4: the kernel rounds the unnormalised probabilities to bf16 per
    # tile, the plain version the normalised ones.
    err, ratio, tol = bf16_out_err(y[:, :, :plen], ref[:, :, :plen], 2**-7)
    del ref
    name = "flash_prefill_window" + (f"@B{B}" if B > 1 else "")
    log(f"[check] {name} P={P} prompt_len={plen} window={W}: y max_abs_err={err:.3e}, max "
        f"err/tol {ratio:.3f} (tol {tol}); two calls bit-equal {same}")
    assert ratio <= 1 and same, f"{name} disagrees with its plain version"
    nodes = graph_nodes_per_call(lambda i: prefill_attn.flash_prefill_window(q, k, v, W))
    mine, n_torch, other = own_and_torch(nodes, ("flash_fwd_kernel",))
    assert mine == {"flash_fwd_kernel": 1} and not other, \
        f"{name}: device operations per call {dict(nodes)}"
    ms = time_ms(lambda i: prefill_attn.flash_prefill_window(q, k, v, W), 5, 1)
    causal_ms = time_ms(lambda i: prefill_attn.flash_pass1(q, k, v), 5, 1)
    plain_ms = time_ms(lambda i: chunked_prefill_partial(q, k, v, plen, window=W), 1, 1)
    pairs = B * H * sum(min(i + 1, W) for i in range(P))  # (query, key) pairs in the window
    nbytes = 2 * (2 * B * H * P * D + 2 * B * KVH * P * D)
    b_ms, b_by = bound(nbytes, 4 * D * pairs, "bf16")
    log(f"[time] {name}: {ms:.3f} ms (bound {b_ms:.3f} ms by {b_by}; "
        f"{4 * D * pairs / ms / 1e9:.1f} TFLOP/s), K4's causal pass 1 on the same inputs "
        f"{causal_ms:.3f} ms, plain {plain_ms:.3f} ms, library: none; {sum(nodes.values())} "
        f"device operations per call ({n_torch} PyTorch's)")
    record(records, name, "flash_prefill_window", "flash_prefill.cu",
           "ops/pallas_prefill.py:167", err, tol, ratio, ms, plain_ms, b_ms, b_by, None, B=B,
           P=P, window=W, causal_pass1_ms=causal_ms, device_kernels_per_call=sum(nodes.values()),
           from_run=M2_RUN)
    del q, k, v, y


def check_window_insert(dev, records):
    """K7's ring insert (``hh_evict_insert(window=1024)``, entry
    ``window_insert``) at Mellum2's sliding layers: four lanes, 4 KV heads of
    8 queries, a 1024-slot kv8 ring, lanes at positions before, on and past
    the ring's first wrap; against its plain version on the same tensors
    over six steps (q, the slot and every cache tensor the same bits), the
    slot each lane's position mod 1024, timed beside its bound."""
    from cold_compress_tpu_torch.caches import init_state
    from cold_compress_tpu_torch.caches.base import CacheSpec
    from cold_compress_tpu_torch.models.rope import precompute_freqs_cis
    from cold_compress_tpu_torch.ops import evict

    B, KVH, W, D = M2_LANES, M2["KVH"], M2["W"], 128
    G = M2["H"] // KVH
    H = KVH * G
    spec = CacheSpec(cache_strategy="window", max_cache_length=W, max_seq_length=4 * W,
                     global_tokens=0, recent_window=W, cache_bits=8,
                     prompt_compression_strategy="recent_global")
    gen = torch.Generator(device=dev).manual_seed(80 + B)
    card = init_state(spec, B, KVH, D, device=dev)
    plain = init_state(spec, B, KVH, D, device=dev)
    freqs = precompute_freqs_cis(4 * W, D, 5e5, device=dev)
    pos = torch.tensor([1000, 1023, 2047, 3000], dtype=torch.int32, device=dev)
    same, slots = True, True
    for step in range(6):
        y = torch.randn((B, 1, (H + 2 * KVH) * D), device=dev, generator=gen).to(torch.bfloat16)
        f = freqs[(pos + step).long()][:, None]
        q, idx = evict.hh_evict_insert(y, f, card, pos + step, n_head=H, n_kv_head=KVH, window=W)
        qp, ip = evict.hh_evict_insert_plain(y, f, plain, pos + step, H, KVH, window=W)
        torch.cuda.synchronize()
        same = same and torch.equal(q, qp.contiguous()) and torch.equal(idx, ip) and all(
            torch.equal(a, b) for a, b in zip(card.tensors(), plain.tensors()))
        slots = slots and idx[:, 0].tolist() == [(p + step) % W for p in pos.tolist()]
    name = f"hh_evict_insert.window@B{B}"
    log(f"[check] {name} KVH={KVH} G={G} C={W}: q, slot and every cache tensor bit-equal over "
        f"6 steps: {same}; slots at position mod {W}: {slots}")
    assert same and slots, f"{name} disagrees with its plain version"
    nodes = graph_nodes_per_call(lambda i: evict.hh_evict_insert(
        y, f, card, pos, n_head=H, n_kv_head=KVH, window=W))
    mine, n_torch, other = own_and_torch(nodes, ("hh_evict_kernel_insert",))
    assert mine == {"hh_evict_kernel_insert": 1} and not other, \
        f"{name}: device operations per call {dict(nodes)}"
    # Reads: the projection's row, the rope row, the position; writes: q, two
    # 128-byte rows, four side scalars, pos, mask, the count and the slot.
    nbytes = (2 * D * B * (H + 2 * KVH) + 4 * D * B + 4 * B + 2 * D * B * H
              + B * KVH * (2 * D + 16 + 4 + 1 + 4 + 4))
    n = copies_for(B * KVH * W * (2 * D + 25))
    states = [card] + [init_state(spec, B, KVH, D, device=dev) for _ in range(n - 1)]
    ms = time_ms(lambda i: evict.hh_evict_insert(y, f, states[i % n], pos, n_head=H,
                                                 n_kv_head=KVH, window=W), 200)
    plain_ms = time_ms(lambda i: evict.hh_evict_insert_plain(y, f, states[i % n], pos, H, KVH,
                                                             window=W), 20)
    b_ms, b_by = bound(nbytes, 0, "bf16")
    log(f"[time] {name}: {ms:.4f} ms (bound {b_ms:.6f} ms by {b_by}), plain {plain_ms:.4f} ms "
        f"({sum(nodes.values())} device operations per fused call, {n_torch} PyTorch's), "
        f"library: none; launch floor {launch_floor_ms():.4f} ms")
    record(records, name, "hh_evict_insert.window", "hh_evict.cu", "ops/pallas_evict.py:57",
           0.0, "bit-equal", 0.0, ms, plain_ms, b_ms, b_by, None, B=B, C=W, H=KVH, G=G,
           device_kernels_per_call=sum(nodes.values()), launch_floor_ms=launch_floor_ms(),
           from_run=M2_RUN)


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


def make_caches(cfg, kw: dict, context: int, device: str, batch: int = 1):
    from cold_compress_tpu_torch.models.transformer import init_caches
    from cold_compress_tpu_torch.runtime.engine import build_cache_specs, cache_compatibility

    cache_compatibility(kw)
    return init_caches(cfg, build_cache_specs(cfg, kw, context), batch, torch.bfloat16,
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
    debug_heavy_hitter shadow's too): the fused rotate-and-insert
    (``hh_evict_insert``) for a kv8 heavy-hitter cache itself, K7 alone
    otherwise. A debug_* cache attends over its full
    bf16 outer cache with pooled probabilities. Each layer's decode attention
    takes the branch that ``i8dot`` (a ``set_attn_i8dot`` mode) routes its
    cache length (``lengths``, per layer) to. With ``prefill_w4a8`` each
    layer projection also runs K8 once, at prefill."""
    from cold_compress_tpu_torch.caches import CacheSpec, get_cache_strategy
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
    window = kw.get("history_window_size", 1)
    if evicting == "heavy_hitter" and window == 1:
        spec = CacheSpec(cache_strategy=strategy, cache_bits=kw["cache_bits"],
                         history_window_size=window)
        fused = get_cache_strategy(strategy).fuses_rotate_insert(spec, cfg.head_dim)
        want["hh_evict_insert" if fused else "hh_evict"] = n * steps
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


def profile_decode(model, caches, tokens, start_pos, steps: int, card: str, run_name: str):
    """Where a decode step's time goes, eager and replayed: wall time per
    step without the profiler, and device time per step by kernel from
    ``torch.profiler``, for ``decode_step`` run eagerly (each lane from its
    token and position) and for the model's captured decode graph replayed
    (its own positions and tokens)."""
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

    tok = torch.tensor(tokens, device="cuda")
    start_pos = torch.tensor(start_pos, dtype=torch.int32, device="cuda")
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
        graph_matches_eager(run_name, model, caches, [prompt], dev)
    if profile:
        profile_decode(model, caches, [seq[-1]], [len(seq)], 8, card, run_name)
        stop_read_cost(model, caches, prompt, cfg.vocab_size, card, run_name)
    return perf, seq, info


def log_capture(run_name, info, card):
    """Print the decode graph that a ``generate()`` call captured (its info)."""
    graph = info["decode_graph"]
    assert graph is not None and graph["captured"], f"{run_name}: no decode graph captured"
    log(f"[e2e] {run_name}: decode graph captured in {graph['capture_seconds']:.3f} s, pool "
        f"{graph['pool_bytes']} bytes, {sum(graph['launches_per_replay'].values())} kernel "
        f"launches per replay  [{card}]")


def graph_matches_eager(run_name, model, caches, prompts, dev, steps: int = 16):
    """From one prefilled state of the lanes ``prompts``, ``steps`` greedy
    steps through the decode graph and the same steps eagerly
    (``decode_loop_core``, each lane from its own position): the same
    tokens, probabilities, last distribution, every cache tensor and kernel
    launches, bit for bit."""
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.generate import (
        decode_loop_core, generate_batch, reset_caches,
    )

    reset_caches(caches)
    # The prefill and the first token only.
    seqs, info, caches = generate_batch(model, caches, prompts, 1)
    tensors = [t for c in caches for t in c.tensors()]
    start = [t.clone() for t in tensors]
    first = torch.tensor([s[-1] for s in seqs], device=dev)
    out = {}
    for graph in (True, False):
        for t, t0 in zip(tensors, start):
            t.copy_(t0)
        reset_kernel_launches()
        tokens, probs, last, n, record = decode_loop_core(
            model, caches, first, info["prompt_lengths"], [], [], steps, cuda_graph=graph)
        out[graph] = ([tokens.cpu(), probs.cpu(), last.cpu()], [t.cpu() for t in tensors],
                      kernel_launches(), n, record)
    (g_out, g_cache, g_launch, g_n, record), (e_out, e_cache, e_launch, e_n, _) = (
        out[True], out[False])
    same_out = all(torch.equal(a, b) for a, b in zip(g_out, e_out))
    same_cache = all(torch.equal(a, b) for a, b in zip(g_cache, e_cache))
    log(f"[e2e] {run_name}: {steps} steps of {len(prompts)} lanes from one prefilled state, "
        f"graph (capture in this call: {record['captured']}) against eager: tokens, "
        f"probabilities bit-equal {same_out}; all {len(tensors)} cache tensors bit-equal "
        f"{same_cache}; launches equal {g_launch == e_launch}; lane 0's tokens "
        f"{g_out[0][:, 0].tolist()}")
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


#: The blocked (lazy-batch) GPTQ form against the row-by-row contract on
#: the same W and H: at most these shares of the codes and of the
#: scale/zero entries differ, a differing entry moves at most this share of
#: its group's scale, and the Hessian-weighted loss at most this share.
#: Measured at most: on the CPU (tests/test_torch_gptq.py) 1.9e-4, 0.28%,
#: 0.039 and 2.24e-3; the card's blocked form on 256 columns of an 8B wq
#: against the CPU's row-by-row one on the card's Hessian (the two inverses
#: round apart too) 9.2e-4, 1.06%, 0.27 and 3.1e-5. A changed code changes
#: the error fed to every later row of its column, so a few columns follow
#: another path. The bound on codes is the one set before measuring; the
#: others are about twice the largest measured.
GPTQ_BLOCKED_BOUNDS = {"codes": 1e-3, "entries": 0.025, "shift": 0.6, "loss": 5e-3}


def hessian_loss(x: torch.Tensor, W: torch.Tensor, leaf, cols: int = 16384) -> float:
    """||X (W_hat - W)|| of an int4 leaf against its dense W [in, out] on
    calibration inputs x [rows, in], f32 products summed in f64 over
    column blocks of ``cols``."""
    from cold_compress_tpu_torch.ops.linear import dequantize_weight

    total = 0.0
    for c0 in range(0, W.shape[1], cols):
        sl = slice(c0, c0 + cols)
        deq = dequantize_weight(leaf["w"][:, sl], leaf["scales"][:, sl], leaf["zeros"][:, sl],
                                leaf["group_size"], torch.float32)
        total += float(((x.float() @ (deq - W[:, sl].float())).double() ** 2).sum())
    return math.sqrt(total)


def blocked_differences(rows: dict, blocked: dict, x: torch.Tensor, W: torch.Tensor) -> dict:
    """The shares ``GPTQ_BLOCKED_BOUNDS`` bounds between two int4 leaves of
    the same W (``rows`` the row-by-row one), on x's device."""
    from cold_compress_tpu_torch.ops.qmm import unpack_rowpack

    dev = x.device
    rows = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in rows.items()}
    blocked = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in blocked.items()}
    codes = unpack_rowpack(rows["w"]) != unpack_rowpack(blocked["w"])
    scale = rows["scales"].float()
    moved = [(rows[k].float() - blocked[k].float()).abs() for k in ("scales", "zeros")]
    loss_r = hessian_loss(x, W.to(dev), rows)
    loss_b = hessian_loss(x, W.to(dev), blocked)
    return {
        "codes": float(codes.float().mean()),
        "entries": float(sum(int((m > 0).sum()) for m in moved) / (2 * scale.numel())),
        "shift": max(float((m / scale).max()) for m in moved),
        "loss": abs(loss_b - loss_r) / loss_r,
    }


def gptq_full_run(dev, card, runs):
    """GPTQ at Llama-3-8B's full width and depth (``quantize --mode
    int4-gptq``'s call: 10 random sequences of 512 tokens, group 128, the
    head last in int4) on bf16 weights drawn on the card, its calibration
    attention K4 once per layer (witnessed), its seconds by part; layer 0's
    seven matrices and the head against plain rounding on the Hessian loss;
    256 columns of layer 0's wq from the card's blocked form against the
    row-by-row contract on the CPU on the card's Hessian; then the file
    through ``save_params`` and ``generate.run`` with bench.py's default
    cache (kv8 heavy_hitter at 25%, the heavy_hitter compressor), the
    default prompt cut to 8192 - 32 byte tokens, 32 tokens."""
    import os
    import shutil

    from cold_compress_tpu_torch.generate import parse_args, run
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import init_params, make_rope_table
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.quantization.gptq import TIMED, gptq_quantize_matrix
    from cold_compress_tpu_torch.quantization.gptq import gptq_quantize_params
    from cold_compress_tpu_torch.quantization.weight_quant import quantize_weight_int4
    from cold_compress_tpu_torch.runtime.engine import save_params

    name = "Meta-Llama-3-8B-Instruct"
    cfg = ModelConfig.from_name(name)
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev)
    rope = make_rope_table(cfg, GPTQ_SEQ, device=dev)
    losses, kept, observe_s = {}, {}, [0.0]

    def observe(layer, matrix, x, H, W, leaf):
        if layer not in (0, None):
            return
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses[matrix] = (hessian_loss(x, W, leaf),
                          hessian_loss(x, W, quantize_weight_int4(W, GPTQ_GROUP)))
        if matrix == "wq":
            kept.update(H=H.cpu(), W=W[:, :256].float().cpu(), x=x.clone(),
                        leaf={k: (v[:, :256].clone() if torch.is_tensor(v) else v)
                              for k, v in leaf.items()})
        torch.cuda.synchronize()
        observe_s[0] += time.perf_counter() - t

    timings = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    t0 = time.perf_counter()
    quantized = gptq_quantize_params(cfg, params, rope, group_size=GPTQ_GROUP,
                                     n_samples=GPTQ_SAMPLES, seq_length=GPTQ_SEQ, verbose=False,
                                     timings=timings, observe=observe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - observe_s[0]
    launches = kernel_launches()
    parts = ", ".join(f"{k} {timings.get(k, 0.0):.1f} s" for k in TIMED)
    log(f"[gptq] {GPTQ_RUN}: {wall:.1f} s on the card ({parts}; the checks' "
        f"{observe_s[0]:.1f} s not counted), peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{card}]")
    witness(GPTQ_RUN, None, launches, {"flash_prefill_summary": cfg.n_layer}, runs)
    for matrix, (g, r) in losses.items():
        log(f"[gptq] Hessian loss ||X (W_hat - W)||, {'head' if matrix == 'output' else 'layer 0'} "
            f"{matrix}: GPTQ {g:.6e}, plain rounding {r:.6e} ({g / r:.4f})")
        assert g <= r, f"GPTQ loses to plain rounding on {matrix}"
    assert len(losses) == 8, sorted(losses)

    t0 = time.perf_counter()
    cpu_leaf = gptq_quantize_matrix(kept["W"], kept["H"], GPTQ_GROUP)
    diff = blocked_differences(cpu_leaf, kept["leaf"], kept["x"], kept["W"])
    log(f"[gptq] layer 0 wq, 256 columns: the card's blocked form against the row-by-row "
        f"contract on the CPU ({time.perf_counter() - t0:.1f} s) on the card's Hessian: "
        + ", ".join(f"{k} {v:.3e} (bound {GPTQ_BLOCKED_BOUNDS[k]})" for k, v in diff.items()))
    assert all(diff[k] <= GPTQ_BLOCKED_BOUNDS[k] for k in diff), diff
    del params, kept, cpu_leaf
    gc.collect()
    torch.cuda.empty_cache()

    tmp = scratch_dir(7 * 10**9)
    try:
        path = os.path.join(tmp, "byte", name, f"model_int4-gptq.g{GPTQ_GROUP}.npz")
        t0 = time.perf_counter()
        save_params(quantized, path)
        log(f"[gptq] save_params: {os.path.getsize(path)} bytes in "
            f"{time.perf_counter() - t0:.1f} s")
        del quantized
        torch.cuda.empty_cache()
        args = parse_args(["--device", dev, "--checkpoint_path", path, "--cache_strategy",
                           "heavy_hitter", "--prompt_compression_strategy", "heavy_hitter",
                           "--max_cache_length", "0.25", "--cache_bits", "8",
                           "--max_new_tokens", "32"])
        reset_kernel_launches()
        seq, info, caches = run(args)
        launches = kernel_launches()
    finally:
        shutil.rmtree(tmp)
    perf = info["perf_stats"]
    P = info["prompt_length"]
    log(f"[gptq] {GPTQ_GEN_RUN}: load {info['load_seconds']:.1f} s, prefill "
        f"{perf['prefill_seconds']:.4f} s for {P} tokens; decode "
        f"{perf['decode_toks_per_sec']:.3f} tok/s over {perf['decode_steps']} steps  [{card}]")
    assert P == 8192 - 32, f"{GPTQ_GEN_RUN}: prompt of {P} tokens, want 8192 - 32"
    check_outputs(GPTQ_GEN_RUN, cfg, seq, info, caches, P, 32)
    witness(GPTQ_GEN_RUN, caches[0].spec.max_cache_length, launches,
            expected_launches(cfg, cli_kw(args), perf["decode_steps"], cache_lengths(caches)),
            runs)


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
    main, main_seq, main_info = e2e_run("main path (heavy_hitter kv8, int4 head)", cfg, model,
                   cache_kw("heavy_hitter", 8), 8192, 128, dev, card, runs, "w4a8_gemv.head",
                   profile, eager_check=True)

    # The main path with decode attention's dequantizing branch (bench
    # --attn_i8dot off), beside it.
    set_attn_i8dot(model, False)
    try:
        off, _, _ = e2e_run("main path, attn_i8dot off", cfg, model, cache_kw("heavy_hitter", 8),
                         8192, 64, dev, card, runs, "w4a8_gemv.head")
    finally:
        set_attn_i8dot(model, "auto")
    log(f"[e2e] main path decode tok/s: attn_i8dot auto (i8dot) "
        f"{main['decode_toks_per_sec']:.3f} over {main['decode_steps']} steps, off "
        f"{off['decode_toks_per_sec']:.3f} over {off['decode_steps']} steps  [{card}]")

    # The main path at 4 lanes (bench --batch 4).
    batch, batch_seqs, batch_info = batch_bench_run(cfg, model, dev, card, runs, main_seq,
                                                    profile)
    log(f"[e2e] main path decode tok/s: batch 1 {main['decode_toks_per_sec']:.3f}, batch "
        f"{BATCH} aggregate {batch['decode_toks_per_sec']:.3f}  [{card}]")

    # FastGen hybrid at bench.py's defaults (its menu and token classes).
    _, hybrid_seq, hybrid_info = e2e_run("hybrid kv8 (bench's FastGen menu)", cfg, model,
                                         cache_kw("hybrid", 8), 8192, 64, dev, card, runs,
                                         "w4a8_gemv.head", profile)

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
    return {"main_seq": main_seq, "main_probs": main_info["emitted_probs"],
            "batch_seqs": batch_seqs, "batch_probs": batch_info["emitted_probs"],
            "hybrid_seq": hybrid_seq, "hybrid_probs": hybrid_info["emitted_probs"]}


#: The batched runs: ``bench --batch 4`` on the main path (lane b's prompt
#: the main path's less 8 b tokens) and the port's ``eval`` over the same
#: model with 4 lanes per call.
BATCH = 4
BATCH_RUN = f"bench --batch {BATCH} (main path, {BATCH} lanes)"
EVAL_RUN = f"eval rulerniah --batch_size {BATCH} (Llama-3-8B int4, heavy_hitter kv8)"
#: The port's eval of the trained TinyByteLM128 fixture, card against CPU:
#: rulerniah, 8 samples, 4 lanes per ``generate_batch`` call, a kv8
#: heavy-hitter cache at a quarter of the median sequence.
EVAL_TRAINED_ARGV = ["--tasks", "rulerniah", "--batch_size", str(BATCH), "--num_samples", "8",
                     "--cache_strategy", "heavy_hitter", "--prompt_compression_strategy",
                     "heavy_hitter", "--max_cache_length", "0.25", "--cache_bits", "8"]


@contextlib.contextmanager
def recorded_generate_calls():
    """(decode steps, cache lengths, info, sequences, cache specs, model,
    keyword arguments) of every ``generate_batch`` and ``generate()`` call
    the port's ``eval`` makes, in the list this yields."""
    from cold_compress_tpu_torch import eval as port_eval

    calls = []
    originals = {name: getattr(port_eval, name) for name in ("generate", "generate_batch")}

    def recording(fn):
        def call(model, caches, *args, **kw):
            out = fn(model, caches, *args, **kw)
            info = out[1]
            steps = info.get("decode_steps", info["perf_stats"].get("decode_steps"))
            calls.append((steps, cache_lengths(out[2]), info, out[0],
                          [c.spec for c in out[2]], model, kw))
            return out
        return call

    for name, fn in originals.items():
        setattr(port_eval, name, recording(fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(port_eval, name, fn)


def eval_launches(cfg, kw, calls, head, layers, i8dot="auto") -> dict:
    """Exact kernel launches of an eval: each generate call's, summed."""
    want = {}
    for steps, lengths, *_ in calls:
        for k, v in expected_launches(cfg, kw, steps, lengths, head, layers=layers,
                                      i8dot=i8dot).items():
            want[k] = want.get(k, 0) + v
    return want


def run_eval(argv, device):
    """The port's ``eval`` CLI into a new temporary directory on
    ``device``: (predictions rows, metrics, recorded calls, seconds)."""
    import csv
    import tempfile

    from cold_compress_tpu_torch import eval as port_eval

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        t0 = time.perf_counter()
        with recorded_generate_calls() as calls:
            assert port_eval.cli([*argv, "--device", device, "--out_dir", tmp]) == 0
        seconds = time.perf_counter() - t0
        task = argv[argv.index("--tasks") + 1]
        with open(f"{tmp}/{task}_predictions.csv", newline="") as f:
            rows = list(csv.reader(f))[1:]
        with open(f"{tmp}/{task}_metrics.json") as f:
            metrics = json.load(f)
    return rows, metrics, calls, seconds


def common_prefix(a: str, b: str) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def in_situ_batch(dev, runs: list):
    """``generate_batch`` on TestKernel (int4 layers and head, kv8
    heavy_hitter at a quarter of 512 slots) over three prompts of 300, 280
    and 260 tokens: greedy through the graph on the card with its exact
    launch witness; each lane's tokens then teacher-forced through
    ``generate()`` on the CPU, probabilities within the in-situ tolerance;
    then the graph against eager steps at B = 3, bit for bit."""
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.generate import generate, generate_batch

    run_name = "in-situ TestKernel generate_batch B=3 heavy_hitter kv8"
    cfg, model = build_model("TestKernel", 0, dev, 512)
    _, model_c = build_model("TestKernel", 0, "cpu", 512)
    base = np.random.RandomState(0).randint(2, 500, size=300).tolist()
    prompts = [base, base[:280], np.random.RandomState(4).randint(2, 500, size=260).tolist()]
    kw = cache_kw("heavy_hitter", 8)
    caches = make_caches(cfg, kw, 512, dev, batch=3)
    reset_kernel_launches()
    seqs, info, caches = generate_batch(model, caches, prompts, 8, prefill_bucket=512)
    launches = kernel_launches()
    assert info["decode_graph"]["captured"] and info["decode_steps"] == 7, run_name
    witness(run_name, caches[0].spec.max_cache_length, launches,
            expected_launches(cfg, kw, info["decode_steps"], cache_lengths(caches)), runs)
    for b, prompt in enumerate(prompts):
        gen = seqs[b][len(prompt):]
        assert seqs[b][: len(prompt)] == prompt and len(gen) == 8, run_name
        _, info_c, _ = generate(model_c, make_caches(cfg, kw, 512, "cpu"), prompt, 8,
                                prefill_bucket=512, next_tokens=gen)
        e_g, e_c = np.asarray(info["emitted_probs"][b]), np.asarray(info_c["emitted_probs"])
        f_g, f_c = np.asarray(info["final_probs"][b]), np.asarray(info_c["final_probs"])
        gap, gap_f, tol = (float(np.abs(e_g - e_c).max()), float(np.abs(f_g - f_c).max()),
                           5e-2 * float(e_c.max()))
        log(f"[parity] {run_name} lane {b} ({len(prompt)} tokens): card tokens {gen}; card vs "
            f"cpu (the card's tokens forced, one lane): emitted_probs max gap {gap:.3e}, "
            f"final_probs max gap {gap_f:.3e} (tol {tol:.3e})")
        assert np.all(np.isfinite(e_g)) and gap <= tol and gap_f <= tol, run_name
    graph_matches_eager("in-situ TestKernel B=3", model, caches, prompts, dev, steps=8)


def state_to(state, device):
    """A copy of one layer's cache state on ``device``."""
    from cold_compress_tpu_torch.caches.base import CacheState

    def moved(val):
        if isinstance(val, CacheState):
            return state_to(val, device)
        return val.to(device, copy=True) if isinstance(val, torch.Tensor) else val

    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    fields = {k: ({n: moved(x) for n, x in v.items()} if k == "extra" else moved(v))
              for k, v in fields.items()}
    return dataclasses.replace(state, **fields)


@contextlib.contextmanager
def recorded_snapkv_scores():
    """The heavy-hitter prompt compressor's scores ([B, KVH, P], f64 on the
    host) of every prefill layer, per device type, in the dict this
    yields."""
    from cold_compress_tpu_torch.caches import prompt_compression as pc

    scores = {}
    fun = pc.PromptCompressorHeavyHitter.token_importances.__func__

    def recording(cls, *args, **kw):
        out = fun(cls, *args, **kw)
        scores.setdefault(out.device.type, []).append(out.detach().double().cpu().numpy())
        return out

    pc.PromptCompressorHeavyHitter.token_importances = classmethod(recording)
    try:
        yield scores
    finally:
        pc.PromptCompressorHeavyHitter.token_importances = classmethod(fun)


def snapkv_ties(scores_g, scores_c, plen, C):
    """The prompt positions that one device keeps among its C best SnapKV
    scores and the other does not (per layer, lane and head). Each must be
    a near-tie: its score lies within the largest card-CPU score gap of
    the positions both keep or both drop from the cut-off (the C-th best
    score), on both sides. Returns (swaps, largest margin, smallest such
    gap over rows with a swap)."""
    swaps, margin, gap_min = 0, 0.0, float("inf")
    for g_l, c_l in zip(scores_g, scores_c):
        shape = (len(plen),) + g_l.shape[1:]
        g_l, c_l = np.broadcast_to(g_l, shape), np.broadcast_to(c_l, shape)
        for b, P in enumerate(plen):
            for h in range(shape[1]):
                g, c = g_l[b, h, :P], c_l[b, h, :P]
                kept_g = set(np.argsort(-g, kind="stable")[:C].tolist())
                kept_c = set(np.argsort(-c, kind="stable")[:C].tolist())
                swapped = sorted(kept_g ^ kept_c)
                if not swapped:
                    continue
                gap = float(np.abs(np.delete(g - c, swapped)).max())
                for score in (g, c):
                    cut = np.sort(score)[::-1][C - 1]
                    m = max(abs(float(score[i] - cut)) for i in swapped)
                    assert m <= gap, f"a kept prompt position {m} from the cut-off, gap {gap}"
                    margin = max(margin, m)
                swaps += len(swapped) // 2
                gap_min = min(gap_min, gap)
    return swaps, margin, gap_min


def stepwise_batch(model, model_c, specs, prompts, gens, bucket, dev):
    """The batched path teacher-forced one step at a time: each lane's
    prompt (padded to ``bucket``) prefilled at once on the card and on the
    CPU, then each step decoded on the card and, on a CPU copy of the
    card's caches, on the CPU, every lane fed its own token of ``gens``
    (one list per lane, equally long) at its own position. Returns the
    card's emitted probabilities [steps + 1, B], the CPU's, per lane the
    prefill logits' largest gap and its bound, the share of prompt
    positions both prefills keep and ``snapkv_ties`` of the prefills;
    asserts that every step evicts the same slots on both sides (from the
    same state, the card's eviction and its plain version agree bit for
    bit)."""
    from cold_compress_tpu_torch.models.transformer import decode_step, init_caches, prefill

    B, n = len(prompts), len(gens[0])
    plen = [len(p) for p in prompts]
    tokens = torch.tensor([p + [0] * (bucket - len(p)) for p in prompts])
    feed = torch.tensor(gens).T  # [steps + 1, B]
    caches = init_caches(model.cfg, specs, B, torch.bfloat16, device=dev)
    caches_c = init_caches(model_c.cfg, specs, B, torch.bfloat16, device="cpu")
    with torch.inference_mode():
        lens = torch.tensor(plen, dtype=torch.int32)
        with recorded_snapkv_scores() as scores:
            logits = prefill(model, caches, tokens.to(dev), lens.to(dev)).float()
            logits_c = prefill(model_c, caches_c, tokens, lens).float()
        ties = snapkv_ties(scores.get("cuda", []), scores.get("cpu", []), plen,
                           specs[0].max_cache_length)
        l_g, l_c = logits.cpu(), logits_c
        prefill_gap = (l_g - l_c).abs().max(-1).values.tolist()
        prefill_tol = (2e-2 * (l_c.max(-1).values - l_c.min(-1).values)).tolist()
        kept = float(np.mean([(c.pos.cpu() == cc.pos).float().mean() for c, cc in
                              zip(caches, caches_c)]))
        lanes = torch.arange(B)
        e_g = [torch.softmax(logits, -1).cpu()[lanes, feed[0]]]  # as generate_batch
        e_c = [torch.softmax(l_c, -1)[lanes, feed[0]]]
        pos = lens
        for i in range(n - 1):
            copy = [state_to(c, "cpu") for c in caches]
            p_g = torch.softmax(decode_step(model, caches, feed[i].to(dev), (pos + i).to(dev))
                                .float(), -1).cpu()
            p_c = torch.softmax(decode_step(model_c, copy, feed[i], pos + i).float(), -1)
            e_g.append(p_g[lanes, feed[i + 1]])
            e_c.append(p_c[lanes, feed[i + 1]])
            assert all(torch.equal(c.pos.cpu(), cc.pos) for c, cc in zip(caches, copy)), \
                f"step {i}: the card and the CPU evict different slots from the same state"
    return (torch.stack(e_g).numpy().astype(np.float64),
            torch.stack(e_c).numpy().astype(np.float64), prefill_gap, prefill_tol, kept, ties)


def in_situ_eval(dev, runs: list):
    """The port's ``eval`` of the trained TinyByteLM128 fixture
    (``EVAL_TRAINED_ARGV``) on the card, its generate calls decoding
    through the graph, with its exact launch witness, against the same eval
    on the CPU: the same prompts and cache statistics. Free-running, card
    and CPU part at near-ties of the fixture's flat next-byte distributions
    and of its heavy-hitter histories (ROADMAP section 3), so each call's
    lanes are then teacher-forced with the card's tokens through the batched
    path one step at a time (``stepwise_batch``): the card's probabilities
    equal those of the eval's own run, the prefill logits agree within the
    in-situ bound, and every decode step, run on the CPU from a copy of the
    card's caches, agrees with the card's within the in-situ tolerance and
    evicts the same slots."""
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches

    argv = ["--checkpoint_path", repo_path(TRAINED_CKPT), *EVAL_TRAINED_ARGV]
    reset_kernel_launches()
    rows, metrics, calls, seconds = run_eval(argv, dev)
    launches = kernel_launches()
    rows_c, metrics_c, calls_c, seconds_c = run_eval(argv, "cpu")
    run_name = "in-situ eval TinyByteLM128 rulerniah --batch_size 4"
    cfg = ModelConfig.from_name("TinyByteLM128")
    kw = {"cache_strategy": ["heavy_hitter"], "cache_bits": 8}
    assert len(calls) == len(calls_c) == 2, run_name
    assert [c[2]["decode_graph"]["captured"] for c in calls] == [True, False], run_name
    witness(run_name, calls[0][1][0], launches, eval_launches(cfg, kw, calls, None, None), runs)
    assert len(rows) == len(rows_c) == 8 and [r[0] for r in rows] == [r[0] for r in rows_c]
    assert abs(metrics["compression_ratio_avg"] - metrics_c["compression_ratio_avg"]) < 1e-6

    report, ok = [], True
    for (_, _, info, seqs, specs, model, gkw), (_, _, info_c, seqs_c, _, model_c, _) in zip(
            calls, calls_c):
        plen = info["prompt_lengths"]
        assert plen == info_c["prompt_lengths"], run_name
        prompts = [seq[:P] for seq, P in zip(seqs, plen)]
        gens = [seq[P:] for seq, P in zip(seqs, plen)]
        assert prompts == [seq[:P] for seq, P in zip(seqs_c, plen)], run_name
        assert len({len(g) for g in gens}) == 1, f"{run_name}: a lane stopped early"
        e_g, e_c, gap_l, tol_l, kept, ties = stepwise_batch(
            model, model_c, specs, prompts, gens, gkw["prefill_bucket"], dev)
        for b in range(len(prompts)):
            run = np.asarray(info["emitted_probs"][b], np.float64)
            tol = 5e-2 * float(e_c[:, b].max())
            gap = float(np.abs(e_g[:, b] - e_c[:, b]).max())
            ok = (ok and np.array_equal(run, e_g[:, b]) and gap <= tol
                  and gap_l[b] <= tol_l[b] and np.all(np.isfinite(run)))
            report.append({
                "shared": common_prefix(gens[b], seqs_c[b][plen[b]:]), "tokens": len(gens[b]),
                "eval run == stepwise": bool(np.array_equal(run, e_g[:, b])),
                "prefill logits gap": round(gap_l[b], 6), "its tol": round(tol_l[b], 6),
                "step gap": round(gap, 6), "tol": round(tol, 6)})
        report.append({"prompt slots alike": round(kept, 4), "SnapKV swaps": ties[0],
                       "their largest margin": ties[1], "smallest gap": ties[2]})
    log(f"[parity] {run_name}: {len(rows)} predictions ({seconds:.1f} s on the card, "
        f"{seconds_c:.1f} s on the cpu), equal to the cpu's: "
        f"{sum(r[1] == rc[1] for r, rc in zip(rows, rows_c))}; per lane (tokens its "
        f"free-running prediction shares with the cpu's, then the card's tokens forced one "
        f"step at a time, each step on the cpu from the card's caches): {json.dumps(report)}; "
        f"StringMatch card {metrics['StringMatch_score']} cpu {metrics_c['StringMatch_score']}; "
        f"compression ratio card {metrics['compression_ratio_avg']:.6f} cpu "
        f"{metrics_c['compression_ratio_avg']:.6f}")
    assert ok, f"{run_name}: the card's probabilities disagree with the CPU's"


def batch_bench_run(cfg, model, dev, card, runs, main_seq, profile=False):
    """``bench --batch 4`` on the main path: lane b's prompt the main
    path's less 8 b tokens, in its bucket; a warm-up call that captures
    the graph, ``reset_caches``, then 128 tokens per lane replayed, with
    its exact launch witness. Lane 0's prompt is the batch-1 main run's:
    its first token must be that run's and its prefill distribution within
    cosine 0.9999 of the batch-1 prefill's."""
    from cold_compress_tpu_torch.models.transformer import prefill
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.generate import generate_batch, reset_caches

    kw = cache_kw("heavy_hitter", 8)
    prompt_len = 8192 - 256 - 8
    prompt = np.random.RandomState(0).randint(5, cfg.vocab_size - 5, size=prompt_len).tolist()
    prompts = [prompt[: prompt_len - 8 * b] for b in range(BATCH)]
    caches = make_caches(cfg, kw, 8192, dev, batch=BATCH)
    _, warm, _ = generate_batch(model, caches, prompts, 8, prefill_bucket=8192)
    log_capture(BATCH_RUN, warm, card)
    reset_caches(caches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    seqs, info, caches = generate_batch(model, caches, prompts, 128, prefill_bucket=8192)
    launches = kernel_launches()
    perf, steps = info["perf_stats"], info["decode_steps"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert not info["decode_graph"]["captured"], f"{BATCH_RUN}: the timed run captured again"
    log(f"[e2e] {BATCH_RUN}: launches {json.dumps({k: v for k, v in launches.items() if v})}")
    log(f"[e2e] {BATCH_RUN}: C={caches[0].spec.max_cache_length}, prompts "
        f"{info['prompt_lengths']}, prefill {perf['prefill_seconds']:.4f} s for "
        f"{perf['prefill_tokens']} tokens ({perf['prefill_toks_per_sec']:.1f} tok/s); decode "
        f"{perf['decode_toks_per_sec']:.3f} tok/s aggregate over {BATCH} lanes x {steps} steps "
        f"(graph replays, {1e3 * perf['decode_seconds'] / steps:.3f} ms per step); capture "
        f"{warm['decode_graph']['capture_seconds']:.3f} s; peak memory {peak_gb:.3f} GB  [{card}]")
    assert steps == 127 and info["num_generated"] == [128] * BATCH, BATCH_RUN
    final = np.asarray(info["final_probs"])
    assert final.shape == (BATCH, cfg.vocab_size) and np.all(np.isfinite(final)), BATCH_RUN
    assert np.all(np.abs(final.sum(-1) - 1.0) < 1e-3), BATCH_RUN
    for b, p in enumerate(prompts):
        gen = seqs[b][len(p):]
        emitted = np.asarray(info["emitted_probs"][b])
        assert seqs[b][: len(p)] == p and len(gen) == 128, BATCH_RUN
        assert all(0 <= t < cfg.vocab_size for t in gen), BATCH_RUN
        assert emitted.shape == (128,) and np.all((emitted > 0) & (emitted <= 1)), BATCH_RUN
        for c in caches:
            pos = c.pos[b].cpu().numpy()
            assert all(len(set(r[r >= 0].tolist())) == int((r >= 0).sum()) for r in pos)
            assert int(c.cache_ct[b].min()) == min(c.spec.max_cache_length, len(p) + steps)
            assert int(pos.max()) == len(p) + 128 - 2, BATCH_RUN  # each lane's last token
    witness(BATCH_RUN, caches[0].spec.max_cache_length, launches,
            expected_launches(cfg, kw, steps, cache_lengths(caches), i8dot=model.attn_i8dot),
            runs)

    # Lane 0 against the batch-1 main run.
    tokens = torch.tensor([p + [0] * (8192 - len(p)) for p in prompts], device=dev)
    with torch.inference_mode():
        one = torch.softmax(prefill(model, make_caches(cfg, kw, 8192, dev), tokens[:1],
                                    prompt_len)[0].float(), -1)
        lanes = torch.softmax(prefill(model, caches, tokens, torch.tensor(
            info["prompt_lengths"], dtype=torch.int32, device=dev)).float(), -1)
    cos = float(torch.nn.functional.cosine_similarity(lanes[0], one, dim=0))
    first_main, first_lane0 = main_seq[prompt_len], seqs[0][prompt_len]
    log(f"[e2e] {BATCH_RUN}: lane 0 first token {first_lane0}, the batch-1 main run's "
        f"{first_main}; prefill distribution cosine against batch 1 {cos:.7f} (bound 0.9999), "
        f"max gap {max_err(lanes[0], one):.3e}")
    assert first_lane0 == first_main and cos >= 0.9999, BATCH_RUN
    reset_caches(caches)
    graph_matches_eager(BATCH_RUN, model, caches, prompts, dev)
    if profile:
        short, _, caches = generate_batch(model, caches, prompts, 2, prefill_bucket=8192)
        profile_decode(model, caches, [s[-1] for s in short],
                       [len(s) for s in short], 8, card, BATCH_RUN)
    return perf, seqs, info


def m2_expected_launches(cfg, caches, steps: int, calls: int, i8dot) -> dict:
    """Exact kernel launches of a Mellum2 ``generate_batch`` run of
    ``steps`` decode steps after ``calls`` prefill calls: per step the two
    attention projections (K1) and the grouped GEMV's two launches in every
    layer, the head (and once per prefill call), decode attention per layer
    at its cache's length and need of probabilities, the fused insert per
    full layer and the ring insert per sliding layer; per prefill call K4
    with summaries (SnapKV) per full layer and its window entry per sliding
    layer; per prefill call the experts' grouped GEMM (gate/up, down) and
    combine per layer."""
    from cold_compress_tpu_torch.caches import get_cache_strategy
    from cold_compress_tpu_torch.ops import decode_attn

    n = cfg.n_layer
    want = {"w4a8_gemv.wqkv": n * steps, "w4a8_gemv.wo": n * steps, "moe_gemv.w13": n * steps,
            "moe_gemv.w2": n * steps, "w4a8_gemv.head": steps + calls,
            "moe_gemm.w13": n * calls, "moe_gemm.w2": n * calls, "moe_combine": n * calls}
    for c in caches:
        ring = c.spec.cache_strategy == "window"
        i8 = decode_attn.i8dot_route(i8dot, 8, c.k.shape[2], cfg.n_kv_head, cfg.head_dim)
        for key, count in ((decode_attn.variant(
                8, get_cache_strategy(c.spec.cache_strategy).needs_attn, i8), steps),
                ("hh_evict_insert.window" if ring else "hh_evict_insert", steps),
                ("flash_prefill_window" if ring else "flash_prefill_summary", calls)):
            want[key] = want.get(key, 0) + count
    return want


def mellum2_run(dev, card, runs):
    """Mellum2-12B-A2.5B at full size (28 layers, 64 experts, random int4
    weights and head from seed 0) through ``generate_batch``: four lanes
    of 8064 tokens (the benchmark cell's short call), kv8 heavy_hitter with
    SnapKV at C = 2048 on the 7 full layers and a 1024-slot ring on each of
    the 21 sliding layers; a warm-up call that captures the decode graph,
    ``reset_caches``, then 64 tokens per lane replayed, with its exact
    launch witness (every count zeroed just before the call and read just
    after) and the grouped GEMV's distinct experts per layer and step;
    every cache holding each position once, every ring exactly the last
    1024; then 16 steps of the graph against eager."""
    from cold_compress_tpu_torch.ops import kernel_launches, moe, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.generate import generate_batch, reset_caches

    context, prompt_len, new = 8192, 8064, 64
    t0 = time.perf_counter()
    cfg, model = build_model(M2_NAME, 0, dev, context)
    build_s = time.perf_counter() - t0
    kw = {"cache_strategy": ["heavy_hitter"], "max_cache_length": [2048],
          "prompt_compression_strategy": ["heavy_hitter"], "global_tokens": 4,
          "recent_window": 10, "cache_bits": 8}
    rng = np.random.RandomState(19)
    prompts = [rng.randint(5, cfg.vocab_size - 5, size=prompt_len).tolist()
               for _ in range(M2_LANES)]
    caches = make_caches(cfg, kw, context, dev, batch=M2_LANES)
    rings = [c for c in caches if c.spec.cache_strategy == "window"]
    assert len(rings) == 21 and all(c.spec.max_cache_length == M2["W"] for c in rings), M2_RUN
    _, warm, _ = generate_batch(model, caches, prompts, 8, prefill_bucket=context)
    log_capture(M2_RUN, warm, card)
    reset_caches(caches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    plain_calls = []
    real_plain = moe.moe_gemm_plain
    moe.moe_gemm_plain = lambda *a, **k: plain_calls.append(1) or real_plain(*a, **k)
    try:
        seqs, info, caches = generate_batch(model, caches, prompts, new, prefill_bucket=context)
    finally:
        moe.moe_gemm_plain = real_plain
    launches = kernel_launches()
    assert not plain_calls, f"{M2_RUN}: the experts' prefill took the plain version"
    perf, steps = info["perf_stats"], info["decode_steps"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert not info["decode_graph"]["captured"], f"{M2_RUN}: the timed run captured again"
    experts = {k: v for k, v in launches.items() if k.startswith("moe_gemv.experts.")}
    rest = {k: v for k, v in launches.items() if k not in experts}
    per_step = [experts.get(f"moe_gemv.experts.{i}", 0) / steps for i in range(cfg.n_layer)]
    log(f"[e2e] {M2_RUN}: launches {json.dumps({k: v for k, v in rest.items() if v})}; "
        f"launches per decode step {json.dumps({k: v / steps for k, v in rest.items() if v})}")
    log(f"[e2e] {M2_RUN}: distinct experts read per decode step by layer "
        f"{[round(v, 3) for v in per_step]} (mean {sum(per_step) / len(per_step):.3f}; uniform "
        f"routing would give {64 * (1 - (56 / 64) ** M2_LANES):.3f})")
    log(f"[e2e] {M2_RUN}: model built in {build_s:.1f} s; prompts {info['prompt_lengths']}, "
        f"prefill {perf['prefill_seconds']:.4f} s for {perf['prefill_tokens']} tokens "
        f"({perf['prefill_toks_per_sec']:.1f} tok/s); decode {perf['decode_toks_per_sec']:.3f} "
        f"tok/s aggregate over {M2_LANES} lanes x {steps} steps (graph replays, "
        f"{1e3 * perf['decode_seconds'] / steps:.3f} ms per step); capture "
        f"{warm['decode_graph']['capture_seconds']:.3f} s; peak memory {peak_gb:.3f} GB  [{card}]")
    assert steps == new - 1 and info["num_generated"] == [new] * M2_LANES, M2_RUN
    assert len(experts) == cfg.n_layer and all(
        M2["K"] <= v <= min(M2["E"], M2["K"] * M2_LANES) for v in per_step), M2_RUN
    final = np.asarray(info["final_probs"])
    assert final.shape == (M2_LANES, cfg.vocab_size) and np.all(np.isfinite(final)), M2_RUN
    assert np.all(np.abs(final.sum(-1) - 1.0) < 1e-3), M2_RUN
    last = prompt_len + new - 2  # each lane's last cached position
    for b, p in enumerate(prompts):
        gen = seqs[b][len(p):]
        emitted = np.asarray(info["emitted_probs"][b])
        assert seqs[b][: len(p)] == p and len(gen) == new, M2_RUN
        assert all(0 <= t < cfg.vocab_size for t in gen), M2_RUN
        assert emitted.shape == (new,) and np.all((emitted > 0) & (emitted <= 1)), M2_RUN
        for c in caches:
            pos = c.pos[b].cpu().numpy()
            assert all(len(set(r[r >= 0].tolist())) == int((r >= 0).sum()) for r in pos)
            assert int(c.cache_ct[b].min()) == min(c.spec.max_cache_length, len(p) + steps)
            assert int(pos.max()) == last, M2_RUN
        for c in rings:
            assert all(sorted(r.tolist()) == list(range(last - M2["W"] + 1, last + 1))
                       for r in c.pos[b].cpu()), f"{M2_RUN}: a ring holds other positions"
    witness(M2_RUN, 2048, rest,
            m2_expected_launches(cfg, caches, steps, 1, model.attn_i8dot), runs)
    reset_caches(caches)
    graph_matches_eager(M2_RUN, model, caches, prompts, dev)
    return perf


def eval_full_run(dev, card, runs):
    """The port's ``eval`` at full width: Llama-3-8B with random int4
    weights and head (``--random_quantize int4``), rulerniah, 8 samples, 4
    lanes per call, a kv8 heavy_hitter cache at a quarter of the median
    sequence; its exact launch witness over every call."""
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches

    argv = ["--random_weights", "Meta-Llama-3-8B-Instruct", "--random_quantize", "int4",
            *EVAL_TRAINED_ARGV]
    cfg = ModelConfig.from_name("Meta-Llama-3-8B-Instruct")
    gc.collect()  # an earlier model and its decode graph reference each other
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    rows, metrics, calls, seconds = run_eval(argv, dev)
    launches = kernel_launches()
    kw = {"cache_strategy": ["heavy_hitter"], "cache_bits": 8}
    lengths = calls[0][1]
    log(f"[e2e] {EVAL_RUN}: launches {json.dumps({k: v for k, v in launches.items() if v})}")
    log(f"[e2e] {EVAL_RUN}: {len(rows)} predictions in {seconds:.1f} s (model build included), "
        f"{len(calls)} generate_batch calls, C={lengths[0]}, prompts "
        f"{[c[2]['prompt_lengths'] for c in calls]}, decode steps {[c[0] for c in calls]}; "
        f"decode tok/s per call {[round(v, 3) for v in metrics['decode_toks_per_sec']]}, "
        f"prefill s per call {[round(c[2]['perf_stats']['prefill_seconds'], 4) for c in calls]}; "
        f"graph captured per call {[c[2]['decode_graph']['captured'] for c in calls]}; "
        f"StringMatch {metrics['StringMatch_score']}, compression ratio "
        f"{metrics['compression_ratio_avg']:.4f}, max memory {metrics['max_memory_gb']:.3f} GB "
        f" [{card}]")
    assert len(rows) == 8 and len(calls) == 2, EVAL_RUN
    assert [c[2]["decode_graph"]["captured"] for c in calls] == [True, False], EVAL_RUN
    assert all(np.isfinite(v) for v in metrics["decode_toks_per_sec"]), EVAL_RUN
    witness(EVAL_RUN, lengths[0], launches,
            eval_launches(cfg, kw, calls, "w4a8_gemv.head", "w4a8_gemv"), runs)
    return lengths[0]


# ---------------------------------------------------------------------------
# Phase 5: tensor and data parallelism across ranks
# ---------------------------------------------------------------------------

MAIN_MODEL = "Meta-Llama-3-8B-Instruct"
TP_CONTEXT = 8192  # the main path's context; its prompt is 264 tokens shorter
#: Tokens of each tensor-parallel run: greedy, then teacher-forced on the
#: single-card run's tokens (fewer where four ranks share one card).
TP_TOKENS = 64
TP_SHARED_TOKENS = {2: 64, 4: 16}
#: Replays of the decode graph profiled for the collectives' device time.
TP_PROFILE_STEPS = 8
#: Probabilities against the single card's, as a share of the largest
#: single-card probability compared (1.75e-4 on the main path): the gaps
#: measured on the H100 came to 0.18-0.81% of it (tp = 2 and 4, dp = 2).
TP_PROB_REL = 2e-2
#: The same for the dense bf16 runs (phase 6). These random bf16 weights
#: amplify any reordering of a sum: on one card, wo and w2 summed in f32 in
#: another order (rounded to bf16 once, as before) part from the card's own
#: run after 11 of 16 tokens, 5.79% of the largest probability apart; tp = 2
#: 8.59%, tp = 2 with f32 partial sums 11.22% (``scripts/torch_tp_reduce_ab.py``,
#: H100 80GB HBM3, 700 W). The bound is about twice the largest of those.
BF16_PROB_REL = 0.25
TP_TIMEOUT_S = 300


def tp_run_name(tp: int) -> str:
    return f"tensor parallel tp={tp} (main path, heavy_hitter kv8, int4 head)"


def dp_run_name(tp: int) -> str:
    return f"generate_batch dp=2 x tp={tp} (main path, {BATCH} lanes)"


def main_prompt(cfg, lane: int = 0) -> list:
    """The main path's 7928-token prompt (``e2e_run``'s at an 8192
    context), less 8 tokens for each lane (``batch_bench_run``'s lanes)."""
    n = TP_CONTEXT - 256 - 8
    prompt = np.random.RandomState(0).randint(5, cfg.vocab_size - 5, size=n).tolist()
    return prompt[: n - 8 * lane]


@functools.lru_cache(maxsize=1)
def rank_params():
    """(config, parameter tree on the host) of the main path's random int4
    Llama-3-8B weights from seed 0, drawn once in each rank's process."""
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params
    from cold_compress_tpu_torch.runtime.engine import params_from_flat

    cfg = ModelConfig.from_name(MAIN_MODEL)
    return cfg, params_from_flat(random_quantized_params(cfg, seed=0, head_mode="int4"), "cpu")


def rank_model(ctx, batch: int = 1, kw=None):
    """This rank's model of the main path's weights under its layout (its
    tp shard, or the whole model under sp or pp) and its caches of ``kw``
    (default the main path's; its KV heads, its replica's lanes), with the
    seconds the build took."""
    from cold_compress_tpu_torch.models.transformer import init_caches
    from cold_compress_tpu_torch.parallel.tp_decode import build_rank_model
    from cold_compress_tpu_torch.runtime.engine import build_cache_specs

    cfg, params = rank_params()
    t0 = time.perf_counter()
    model = build_rank_model(cfg, params, ctx, max_positions=TP_CONTEXT)
    torch.cuda.synchronize(ctx.device)
    build_s = time.perf_counter() - t0
    specs = build_cache_specs(cfg, kw or cache_kw("heavy_hitter", 8), TP_CONTEXT)
    lanes = batch // getattr(ctx, "dp", 1)
    caches = init_caches(model.cfg, specs, lanes, torch.bfloat16, device=ctx.device)
    return cfg, model, caches, build_s


def collective_ms(model, steps: int) -> dict:
    """Device ms per step of the tp group's all-reduces and all-gather, and
    of the whole step, over ``steps`` replays of the model's captured
    decode graph (``torch.profiler``)."""
    from cold_compress_tpu_torch.runtime.cuda_graph import model_decode_graph

    graph = model_decode_graph(model)

    def replay():
        with graph.on_stream():
            for _ in range(steps):
                graph.replay()

    with torch.inference_mode():
        busy, _, rows = device_profile(replay, steps)
    out = {kind: sum(e.self_device_time_total for e in rows if kind in e.key) / 1e3 / steps
           for kind in ("AllReduce", "AllGather")}
    return {**out, "busy": busy}


def tp_rank(ctx, new_tokens: int, teacher: list, profile: bool) -> dict:
    """One rank of the tensor-parallel main path: a warm-up ``generate``
    (capturing the decode graph over NCCL), ``new_tokens`` greedy tokens
    with the rank's exact launch witness and output checks, then the
    tokens ``teacher`` teacher-forced; with ``profile``, the collectives'
    device time per replayed step."""
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.generate import generate, reset_caches

    dev, run = ctx.device, tp_run_name(ctx.tp)
    cfg, model, caches, build_s = rank_model(ctx)
    kw = cache_kw("heavy_hitter", 8)
    prompt = main_prompt(cfg)
    _, warm, _ = generate(model, caches, prompt, 8)
    reset_caches(caches)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_kernel_launches()
    seq, info, caches = generate(model, caches, prompt, new_tokens)
    launches = {k: v for k, v in kernel_launches().items() if v}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check_outputs(run, cfg, seq, info, caches, len(prompt), new_tokens)
    steps = info["perf_stats"]["decode_steps"]
    want = expected_launches(model.cfg, kw, steps, cache_lengths(caches), i8dot=model.attn_i8dot)
    assert launches == want, f"{run}, rank {ctx.rank}: launches {launches}, want {want}"
    graph = info["decode_graph"]
    assert (graph is not None) == ctx.capturable, run
    assert graph is None or not graph["captured"], f"{run}: the timed run captured again"
    reset_caches(caches)
    _, forced, _ = generate(model, caches, prompt, len(teacher), next_tokens=teacher)
    return {"rank": ctx.rank, "device": str(dev), "build_s": build_s, "tokens": seq[len(prompt):],
            "perf": info["perf_stats"], "peak_gb": peak_gb, "launches": launches,
            "C": caches[0].spec.max_cache_length, "heads": (model.cfg.n_head, model.cfg.n_kv_head),
            "teacher_probs": forced["emitted_probs"], "capture": warm["decode_graph"],
            "collectives": collective_ms(model, TP_PROFILE_STEPS) if profile else None}


def dp_rank(ctx, new_tokens: int) -> dict:
    """One rank of ``generate_batch`` over the batch run's four lanes, dp = 2
    replicas of two lanes each: a warm-up call, then ``new_tokens`` tokens
    per lane with the rank's exact launch witness."""
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.generate import generate_batch, reset_caches

    dev, run = ctx.device, dp_run_name(ctx.tp)
    cfg, model, caches, build_s = rank_model(ctx, BATCH)
    kw = cache_kw("heavy_hitter", 8)
    prompts = [main_prompt(cfg, b) for b in range(BATCH)]
    generate_batch(model, caches, prompts, 8, prefill_bucket=TP_CONTEXT)
    reset_caches(caches)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_kernel_launches()
    seqs, info, caches = generate_batch(model, caches, prompts, new_tokens,
                                        prefill_bucket=TP_CONTEXT)
    launches = {k: v for k, v in kernel_launches().items() if v}
    steps = info["decode_steps"]
    want = expected_launches(model.cfg, kw, steps, cache_lengths(caches), i8dot=model.attn_i8dot)
    assert launches == want, f"{run}, rank {ctx.rank}: launches {launches}, want {want}"
    assert steps == new_tokens - 1 and info["num_generated"] == [new_tokens] * BATCH, run
    return {"rank": ctx.rank, "build_s": build_s, "seqs": seqs, "emitted": info["emitted_probs"],
            "perf": info["perf_stats"], "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "launches": launches, "C": caches[0].spec.max_cache_length,
            "graph": info["decode_graph"] is not None}


def prob_gap(got, ref, rel: float = TP_PROB_REL) -> tuple:
    """(largest gap, its bound): probabilities against the single card's,
    within ``rel`` of the largest single-card one."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.all(np.isfinite(got)), (got.shape, ref.shape)
    return float(np.abs(got - ref).max()), rel * float(ref.max())


@functools.lru_cache(maxsize=None)
def reference_top2(ref: str, ref_tokens: tuple, k: int) -> tuple:
    """The two largest probabilities of the single card's run ``ref``
    ("main", "hybrid": phase 4's on the int4 weights; "bf16": the dense
    bf16 one) at its greedy step ``k``: the run rebuilt on the card and
    teacher-forced over its first k + 1 tokens (``ref_tokens``)."""
    from cold_compress_tpu_torch.runtime.generate import generate

    dev = "cuda"
    cfg, model = (bf16_single_model(dev) if ref == "bf16"
                  else build_model(MAIN_MODEL, 0, dev, TP_CONTEXT))
    caches = make_caches(cfg, cache_kw("hybrid" if ref == "hybrid" else "heavy_hitter", 8),
                         TP_CONTEXT, dev)
    _, info, _ = generate(model, caches, main_prompt(cfg), k + 1, next_tokens=list(ref_tokens))
    probs = np.asarray(info["final_probs"], np.float64)
    assert probs[ref_tokens[k]] == probs.max(), f"{ref}: step {k} rebuilt is not the run's"
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    top = np.sort(probs)[-2:]
    return float(top[1]), float(top[0])


def check_greedy(run: str, rank: int, tokens: list, ref_tokens: list, tol: float,
                 ref, card: str) -> None:
    """Greedy tokens equal to the reference's up to the first that parts.
    Where each probability may move by ``tol``, a token can part only where
    the reference's two most likely tokens are within 2 x ``tol``: there
    the single card's run ``ref`` (``reference_top2``) must have such a
    near-tie. Past it the runs see different tokens, and the teacher-forced
    probabilities hold the rest. A reference of another run of the world
    (``ref`` None) holds every token."""
    k = common_prefix(tokens, ref_tokens)
    if k == len(tokens):
        return
    assert ref is not None, f"{run}, rank {rank}: greedy tokens {tokens}, reference {ref_tokens}"
    p1, p2 = reference_top2(ref, tuple(ref_tokens[:k + 1]), k)
    log(f"[check] {run}, rank {rank}: greedy token {k} parts from the single card's, whose two "
        f"most likely there are {p1:.4e} and {p2:.4e}, {p1 - p2:.3e} apart (near-tie bound "
        f"{2 * tol:.3e})  [{card}]")
    assert p1 - p2 <= 2 * tol, (
        f"{run}, rank {rank}: greedy token {k} parts from the single card's at a margin "
        f"{p1 - p2:.3e}, above {2 * tol:.3e}")


def check_tp_ranks(results, refs, n_teacher: int, backend: str, card: str, runs: list) -> None:
    """Every rank's greedy tokens the single-card run's; teacher-forced
    probabilities within TP_PROB_REL of its largest; per-rank numbers
    printed (timing only where each rank has its own card)."""
    tp = len(results)
    run = tp_run_name(tp)
    prompt_len = TP_CONTEXT - 256 - 8
    ref_tokens = refs["main_seq"][prompt_len:]
    ref_probs = refs["main_probs"][:n_teacher]
    for res in results:
        gap, tol = prob_gap(res["teacher_probs"], ref_probs)
        perf = res["perf"]
        timing = (f"prefill {perf['prefill_seconds']:.4f} s, decode "
                  f"{perf['decode_toks_per_sec']:.3f} tok/s over {perf['decode_steps']} steps "
                  f"(graph replays), peak memory {res['peak_gb']:.3f} GB" if backend == "nccl"
                  else f"eager decode over {perf['decode_steps']} steps (no timing)")
        log(f"[phase5] {run}, rank {res['rank']} on {res['device']} ({res['heads'][0]} query / "
            f"{res['heads'][1]} KV heads): built in {res['build_s']:.1f} s; {timing}; launches "
            f"{json.dumps(res['launches'])}; greedy tokens equal to the single card's for "
            f"{common_prefix(res['tokens'], ref_tokens)} of {len(res['tokens'])}; {n_teacher} "
            f"teacher-forced steps within {gap:.3e} of the single card's probabilities (bound "
            f"{tol:.3e}, {TP_PROB_REL} of the largest)  [{card}]")
        if res["collectives"]:
            c = res["collectives"]
            log(f"[phase5] {run}, rank {res['rank']}: one profiled replay of "
                f"{TP_PROFILE_STEPS} steps: all-reduce {c['AllReduce']:.4f} ms, all-gather "
                f"{c['AllGather']:.4f} ms, device busy {c['busy']:.3f} ms per step  [{card}]")
        if res["capture"]:
            log_capture(f"{run}, rank {res['rank']}", {"decode_graph": res["capture"]}, card)
        check_greedy(run, res["rank"], res["tokens"], ref_tokens[:len(res["tokens"])], tol,
                     "main", card)
        assert gap <= tol, f"{run}, rank {res['rank']}: probabilities {gap} apart, bound {tol}"
    runs.append((run, results[0]["C"], results[0]["launches"]))


def check_dp_ranks(results, tp: int, refs, backend: str, card: str, runs: list) -> None:
    """Each lane of every rank's gathered lanes against the single-card
    ``generate_batch`` lane: the same greedy tokens, and probabilities
    within TP_PROB_REL of the largest of the single card's."""
    run = dp_run_name(tp)
    seqs = results[0]["seqs"]
    for res in results:
        assert res["seqs"] == seqs, f"{run}: rank {res['rank']}'s lanes differ from rank 0's"
    for b, (seq, ref) in enumerate(zip(seqs, refs["batch_seqs"])):
        plen = TP_CONTEXT - 256 - 8 - 8 * b
        gen, ref_gen = seq[plen:], ref[plen:len(seq)]
        same = common_prefix(gen, ref_gen)
        gap, tol = prob_gap(results[0]["emitted"][b], refs["batch_probs"][b][:len(gen)])
        log(f"[phase5] {run}, lane {b}: greedy tokens equal to the single card's for {same} of "
            f"{len(gen)}; probabilities within {gap:.3e} (bound {tol:.3e}, {TP_PROB_REL} of the "
            f"largest)")
        assert seq[:plen] == ref[:plen] and gen == ref_gen and gap <= tol, run
    for res in results:
        perf = res["perf"]
        log(f"[phase5] {run}, rank {res['rank']}: launches {json.dumps(res['launches'])}; "
            + (f"prefill {perf['prefill_seconds']:.4f} s, decode {perf['decode_toks_per_sec']:.3f}"
               f" tok/s aggregate over {BATCH} lanes (graph: {res['graph']}), peak memory "
               f"{res['peak_gb']:.3f} GB" if backend == "nccl" else "(ranks share a card: no "
               "timing)") + f"  [{card}]")
    runs.append((run, results[0]["C"], results[0]["launches"]))


def parallel_phase(card: str, runs: list, refs: dict) -> None:
    """Phases 5 and 6 at full width over ranks, each world of ranks
    started once for both: tensor and data parallelism (phase 5), then
    sequence and pipeline parallelism (phase 6). NCCL with one card per
    rank where the machine lends enough cards, else gloo with the ranks
    sharing the card (correctness only)."""
    from cold_compress_tpu_torch.parallel.launch import launch, run_jobs
    from cold_compress_tpu_torch.parallel.mesh import Layout

    n = torch.cuda.device_count()
    prompt_len = TP_CONTEXT - 256 - 8
    teacher = refs["main_seq"][prompt_len:prompt_len + TP_TOKENS]
    if n >= 4:
        worlds = [(2, [(Layout(tp=2), tp_rank, (TP_TOKENS, teacher, True))]),
                  (4, [(Layout(tp=4), tp_rank, (TP_TOKENS, teacher, True)),
                       (Layout(tp=2, dp=2), dp_rank, (TP_TOKENS,))])]
    else:
        short = teacher[:TP_SHARED_TOKENS[4]]
        worlds = [(2, [(Layout(tp=2), tp_rank, (TP_SHARED_TOKENS[2], teacher, n >= 2)),
                       (Layout(dp=2), dp_rank, (TP_TOKENS,))]),
                  (4, [(Layout(tp=4), tp_rank, (TP_SHARED_TOKENS[4], short, False))])]
    log(f"[phase5] {n} card(s) visible: {torch.cuda.get_device_name(0)}")
    for world, jobs in worlds:
        backend = "nccl" if n >= world else "gloo"
        # Phase 6's jobs ride the same ranks (each rank draws the weights once).
        par = par_jobs(refs, world, backend, n >= 4)
        jobs = jobs + [job for _, job, _ in par]
        log(f"[phase5] {world} ranks over {backend}: " + (
            "one card per rank" if backend == "nccl"
            else f"ranks share {n} card(s): correctness only, no timing"))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        per_rank = launch(run_jobs, jobs, dp=world, device="cuda", backend=backend,
                          timeout_s=TP_TIMEOUT_S)
        log(f"[phase5] {world} ranks ran {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s")
        n_tp = len(jobs) - len(par)
        for j, (layout, fn, args) in enumerate(jobs[:n_tp]):
            results = [r[j] for r in per_rank if r[j] is not None]
            if fn is tp_rank:
                check_tp_ranks(results, refs, len(args[1]), backend, card, runs)
            else:
                check_dp_ranks(results, layout.tp, refs, backend, card, runs)
        check_par_jobs(par, [r[n_tp:] for r in per_rank], refs, backend, card, runs)


# ---------------------------------------------------------------------------
# Phase 6: sequence and pipeline parallelism across ranks
# ---------------------------------------------------------------------------

#: Tokens of each sequence- or pipeline-parallel run (greedy, then
#: teacher-forced): fewer where the ranks share one card.
PAR_TOKENS = {"gloo": 16, "nccl": 64}
#: The dense bf16 Llama-3-8B of the sp x tp run: ``init_params``' draws from
#: a generator on the card with this seed.
BF16_SEED = 5


def sp_run_name(sp: int, tp: int = 1, strategy: str = "heavy_hitter") -> str:
    weights = "bf16 layers and head" if tp > 1 else "int4"
    return (f"sequence parallel sp={sp}" + (f" x tp={tp}" if tp > 1 else "")
            + f" ({strategy} kv8, {weights})")


def pp_run_name(pp: int) -> str:
    return f"pipeline parallel pp={pp} (main path, heavy_hitter kv8, int4)"


def bf16_draws(cfg, device):
    """``init_params``' bf16 draws of ``cfg`` from a generator on
    ``device`` seeded ``BF16_SEED``, in its order: each layer's tree, then
    ``("tok_embeddings", t)`` and ``("output", t)``. A rank keeps its shard
    of each layer as it comes, never the whole model."""
    gen = torch.Generator(device=device).manual_seed(BF16_SEED)
    D, H, KVH, hd, I = cfg.dim, cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.intermediate_size

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(torch.bfloat16)

    for _ in range(cfg.n_layer):
        attn = {"wq": dense(D, H * hd), "wk": dense(D, KVH * hd), "wv": dense(D, KVH * hd),
                "wo": dense(H * hd, D)}
        ffn = {"w1": dense(D, I), "w3": dense(D, I), "w2": dense(I, D)}
        yield {"attn": attn, "ffn": ffn,
               "attention_norm": torch.ones(D, dtype=torch.bfloat16, device=device),
               "ffn_norm": torch.ones(D, dtype=torch.bfloat16, device=device)}
    yield "tok_embeddings", dense(cfg.vocab_size, D)
    yield "output", dense(D, cfg.vocab_size)


def bf16_rank_model(ctx, kw):
    """This tp or sp x tp rank's shard of the bf16 8B model
    (``bf16_draws``, each layer sharded as it is drawn: ``prepare_tp``'s
    slicing), built over the local config holding its contexts, and its
    caches."""
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import init_caches
    from cold_compress_tpu_torch.parallel.tp_decode import _head_local, local_cfg, prepare_tp
    from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model

    cfg = ModelConfig.from_name(MAIN_MODEL)
    tp, t, dev = ctx.tp, ctx.rank % ctx.tp, ctx.device
    tp_ctx = getattr(ctx, "tp_ctx", ctx)  # an SpContext holds its replica's
    t0 = time.perf_counter()
    layers, rest = [], {}
    for item in bf16_draws(cfg, dev):
        if isinstance(item, dict):
            one = {"tok_embeddings": None, "norm": None, "layers": [item], "output": None}
            layers.append(prepare_tp(cfg, one, tp, t)["layers"][0])
        else:
            rest[item[0]] = item[1]
        del item
    params = {"tok_embeddings": rest["tok_embeddings"], "layers": layers,
              "norm": torch.ones(cfg.dim, dtype=torch.bfloat16, device=dev),
              "output": _head_local(rest.pop("output"), t, tp)}
    model = build_model(local_cfg(cfg, tp), params, dev, max_positions=TP_CONTEXT)
    del params, layers, rest
    model.tp = tp_ctx
    if tp_ctx is not ctx:
        model.sp = ctx
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    caches = init_caches(model.cfg, build_cache_specs(cfg, kw, TP_CONTEXT), 1, torch.bfloat16,
                         device=dev)
    return cfg, model, caches, build_s


def bf16_single_model(dev):
    """(config, model) of the bf16 8B weights on one card (``init_params``
    with ``BF16_SEED``)."""
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import init_params
    from cold_compress_tpu_torch.runtime.engine import build_model as build

    cfg = ModelConfig.from_name(MAIN_MODEL)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(BF16_SEED),
                         torch.bfloat16, dev)
    return cfg, build(cfg, params, dev, max_positions=TP_CONTEXT)


def bf16_reference(dev, card) -> dict:
    """The single card's run of the sp x tp run's bf16 8B model
    (``bf16_single_model``), the main path's cache and prompt, 64 greedy
    tokens: its tokens and their probabilities."""
    from cold_compress_tpu_torch.runtime.generate import generate

    t0 = time.perf_counter()
    cfg, model = bf16_single_model(dev)
    caches = make_caches(cfg, cache_kw("heavy_hitter", 8), TP_CONTEXT, dev)
    prompt = main_prompt(cfg)
    seq, info, caches = generate(model, caches, prompt, PAR_TOKENS["nccl"])
    check_outputs("bf16 8B single card", cfg, seq, info, caches, len(prompt), PAR_TOKENS["nccl"])
    perf = info["perf_stats"]
    log(f"[phase6] bf16 Llama-3-8B on one card (the sp x tp run's reference): built and run in "
        f"{time.perf_counter() - t0:.1f} s; prefill {perf['prefill_seconds']:.4f} s, decode "
        f"{perf['decode_toks_per_sec']:.3f} tok/s, peak {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        f" GB  [{card}]")
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    return {"bf16_seq": seq, "bf16_probs": info["emitted_probs"]}


PREFILL_COLLECTIVES = ("AllGather", "AllReduce", "SendRecv", "Broadcast")


def prefill_device_ms(model, caches, prompt) -> dict:
    """Device ms of one more prefill, by kind: the NCCL collectives and the
    query-block kernel's passes (``torch.profiler``)."""
    from cold_compress_tpu_torch.runtime.generate import generate, reset_caches

    reset_caches(caches)
    with torch.inference_mode():
        busy, _, rows = device_profile(lambda: generate(model, caches, prompt, 1), 1)
    out = {kind: sum(e.self_device_time_total for e in rows if kind in e.key) / 1e3
           for kind in PREFILL_COLLECTIVES}
    out["partial"] = sum(e.self_device_time_total for e in rows
                         if any(k in e.key for k in PREFILL_KERNELS)) / 1e3
    return {**out, "busy": busy}


def par_launches(model, kw, steps: int, caches, P: int = TP_CONTEXT) -> dict:
    """A rank's exact launches: the main path's decode
    (``expected_launches``; dense layers and head for the bf16 model) and,
    under sp or pp, in place of the prefill's K4 (K6 for hybrid), its
    query-block form: once per layer under sp, once per layer and chunk of
    64 rows on a pipeline stage."""
    from cold_compress_tpu_torch.ops.linear import DenseLinear

    dense = isinstance(model.output, DenseLinear)
    want = expected_launches(model.cfg, kw, steps, cache_lengths(caches),
                             None if dense else "w4a8_gemv.head",
                             layers=None if dense else "w4a8_gemv", i8dot=model.attn_i8dot)
    if model.sp is None and model.pp is None:
        return want
    key = "flash_profile" if kw["cache_strategy"][0] == "hybrid" else "flash_prefill_summary"
    n = want.pop(key)
    if model.pp is not None:
        n = model.cfg.n_layer // model.pp.pp * (P // PP_CHUNK)
    want["flash_profile_partial" if key == "flash_profile" else "flash_prefill_partial"] = n
    return want


def par_rank(ctx, run: str, kw: dict, new_tokens: int, teacher: list, profile: bool,
             bf16: bool = False) -> dict:
    """One rank of a sequence- or pipeline-parallel run of the main path's
    prompt: a warm-up ``generate``, ``new_tokens`` greedy tokens with the
    rank's exact launch witness and output checks, then ``teacher``
    teacher-forced; with ``profile``, the device ms of one more prefill by
    kind."""
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.generate import generate, reset_caches

    dev = ctx.device
    if bf16:
        cfg, model, caches, build_s = bf16_rank_model(ctx, kw)
    else:
        cfg, model, caches, build_s = rank_model(ctx, kw=kw)
    prompt = main_prompt(cfg)
    _, warm, _ = generate(model, caches, prompt, 8)
    reset_caches(caches)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_kernel_launches()
    seq, info, caches = generate(model, caches, prompt, new_tokens)
    launches = {k: v for k, v in kernel_launches().items() if v}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    hybrid = kw["cache_strategy"][0] == "hybrid"
    check_outputs(run, cfg, seq, info, caches, len(prompt), new_tokens, hybrid)
    want = par_launches(model, kw, info["perf_stats"]["decode_steps"], caches)
    assert launches == want, f"{run}, rank {ctx.rank}: launches {launches}, want {want}"
    graph = info["decode_graph"]
    assert graph is None or not graph["captured"], f"{run}: the timed run captured again"
    reset_caches(caches)
    _, forced, _ = generate(model, caches, prompt, len(teacher), next_tokens=teacher)
    out = {"rank": ctx.rank, "device": str(dev), "build_s": build_s, "tokens": seq[len(prompt):],
           "perf": info["perf_stats"], "peak_gb": peak_gb, "launches": launches,
           "C": caches[0].spec.max_cache_length, "graph": graph is not None,
           "teacher_probs": forced["emitted_probs"],
           "prefill_ms": prefill_device_ms(model, caches, prompt) if profile else None}
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_par_ranks(run: str, results, ref_seq, ref_probs, rel: float, ref, against: str,
                    backend: str, card: str) -> None:
    """Every rank's greedy tokens the reference run's up to the first that
    parts (``check_greedy``; ``ref`` names the single card's run, None for
    another run of this world, ``against`` says which), its teacher-forced
    probabilities within ``rel`` of the largest of the reference's;
    per-rank numbers printed (timed only where each rank has its own
    card)."""
    prompt_len = TP_CONTEXT - 256 - 8
    ref_tokens = ref_seq[prompt_len:]
    for res in results:
        n = len(res["tokens"])
        gap, tol = prob_gap(res["teacher_probs"], ref_probs[:n], rel)
        perf = res["perf"]
        timing = (f"prefill {perf['prefill_seconds']:.4f} s, decode "
                  f"{perf['decode_toks_per_sec']:.3f} tok/s over {perf['decode_steps']} steps "
                  f"(graph: {res['graph']}), peak memory {res['peak_gb']:.3f} GB"
                  if backend == "nccl" else f"{perf['decode_steps']} decode steps (graph: "
                  f"{res['graph']}; ranks share a card: no timing)")
        log(f"[phase6] {run}, rank {res['rank']} on {res['device']}: built in "
            f"{res['build_s']:.1f} s; {timing}; launches {json.dumps(res['launches'])}; greedy "
            f"tokens equal to {against} for {common_prefix(res['tokens'], ref_tokens)} of {n}; "
            f"{n} teacher-forced steps within {gap:.3e} of {against} probabilities ({gap / tol * rel:.2e}"
            f" of the largest; bound {tol:.3e}, {rel})  [{card}]")
        if res["prefill_ms"]:
            log(f"[phase6] {run}, rank {res['rank']}: one profiled prefill, device ms: "
                + ", ".join(f"{k} {v:.3f}" for k, v in res["prefill_ms"].items()) + f"  [{card}]")
        check_greedy(run, res["rank"], res["tokens"], ref_tokens[:n], tol, ref, card)
        assert gap <= tol, f"{run}, rank {res['rank']}: probabilities {gap} apart, bound {tol}"


def check_par_jobs(par: list, per_rank: list, refs: dict, backend: str, card: str,
                   runs: list) -> None:
    """Check each of ``par_jobs``' runs from every rank's results of them,
    in order, against each of its references (a run of this world held to
    one checked before it)."""
    prompt_len = TP_CONTEXT - 256 - 8
    done = {}
    for j, (name, _, held) in enumerate(par):
        results = done[name] = [r[j] for r in per_rank if r[j] is not None]
        for ref, rel in held:
            if ref in done:  # another run of this world, rank 0's
                seq, probs = prompt_len * [0] + done[ref][0]["tokens"], done[ref][0]["teacher_probs"]
                check_par_ranks(name, results, seq, probs, rel, None, f"{ref} rank 0's", backend,
                                card)
            else:
                check_par_ranks(name, results, refs[f"{ref}_seq"], refs[f"{ref}_probs"], rel, ref,
                                "the single card's", backend, card)
        runs.append((name, results[0]["C"], results[0]["launches"]))


BF16_TP_RUN = "tensor parallel tp=2 (heavy_hitter kv8, bf16 layers and head)"


def par_jobs(refs: dict, world: int, backend: str, four_cards: bool) -> list:
    """Phase 6's jobs in a world of ``world`` ranks: (run name, its
    ``run_jobs`` job, what it is held to: (reference, bound) pairs, the
    reference a single card's run of ``refs`` or a run of this world). The
    dense bf16 runs are held to the single card at BF16_PROB_REL, and sp x
    tp also to bf16 tp = 2 at TP_PROB_REL."""
    from cold_compress_tpu_torch.parallel.mesh import Layout

    hh, hyb = cache_kw("heavy_hitter", 8), cache_kw("hybrid", 8)
    main = [("main", TP_PROB_REL)]
    if world == 2:
        specs = [(sp_run_name(2), Layout(sp=2), hh, main, False),
                 (sp_run_name(2, strategy="hybrid"), Layout(sp=2), hyb,
                  [("hybrid", TP_PROB_REL)], False),
                 (pp_run_name(2), Layout(pp=2), hh, main, False)]
    else:
        bf16 = ("bf16", BF16_PROB_REL)
        specs = [(sp_run_name(4), Layout(sp=4), hh, main, False),
                 (BF16_TP_RUN, Layout(tp=2), hh, [bf16], True),
                 (sp_run_name(2, 2), Layout(sp=2, tp=2), hh, [bf16, (BF16_TP_RUN, TP_PROB_REL)],
                  True)]
        if four_cards:
            specs.append((pp_run_name(4), Layout(pp=4), hh, main, False))
    n = PAR_TOKENS[backend]
    prompt_len = TP_CONTEXT - 256 - 8
    return [(name, (layout, par_rank, (name, kw, n,
                                       refs[f"{held[0][0]}_seq"][prompt_len:prompt_len + n],
                                       backend == "nccl", bf16)), held)
            for name, layout, kw, held, bf16 in specs]


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
    # One tensor-parallel rank's shapes (phase 5's runs launch them).
    for tp in (2, 4):
        check_w4a8(dev, records, tp=tp, from_run=tp_run_name(tp))
        check_decode(dev, records, 8, True, 2048, i8dot=True, tp=tp, from_run=tp_run_name(tp))
        check_hh_evict_insert(dev, records, KVH=8 // tp, tp=tp, from_run=tp_run_name(tp))
    runs = []  # (run name, its cache length, its launches), phase 4 first
    check_w4a8(dev, records)
    check_w4a8(dev, records, L=BATCH, also_L=(8,), from_run=BATCH_RUN)
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
    # Decode attention at the batched run's shapes: its i8dot branch (the
    # eval's dequantizing one follows that run, at its cache length).
    check_decode(dev, records, 8, True, 2048, i8dot=True, B=BATCH, from_run=BATCH_RUN)
    check_hh_evict(dev, records)
    # The fused insert at both benchmark cells' shapes (the main path's and
    # Qwen2-7B's 4 KV heads of 7 queries at B = 4, whose launches the batch
    # run reports), and at the batch run's.
    check_hh_evict_insert(dev, records)
    check_hh_evict_insert(dev, records, B=BATCH, from_run=BATCH_RUN)
    check_hh_evict_insert(dev, records, B=BATCH, KVH=4, G=7, from_run=BATCH_RUN)
    for name, IN, OUT in W8A8_SHAPES:
        check_w8a8(dev, records, name, IN, OUT)
    check_flash_prefill(dev, records)
    check_flash_prefill(dev, records, plens=tuple(7928 - 8 * b for b in range(BATCH)),
                        from_run=BATCH_RUN)
    check_flash_prefill_calibration(dev, records)
    for windows in ((2457,), (819, 2457)):
        check_flash_profile(dev, records, windows)
    # The query blocks of phase 6's runs.
    check_partial_offset0_bit_equal(dev)
    for Pq, q_offset, sp in PARTIAL_BLOCKS:
        check_flash_prefill_partial(dev, records, Pq, q_offset, sp_run_name(sp))
    for q_offset in PP_CHUNK_OFFSETS:
        check_flash_prefill_partial(dev, records, PP_CHUNK, q_offset, pp_run_name(2),
                                    Pk=q_offset + PP_CHUNK)
    for windows in ((2457,), (819, 2457)):
        check_flash_profile_partial(dev, records, windows, sp_run_name(2, strategy="hybrid"))
    check_w4a8_gemm(dev, records)
    # Mellum2-12B-A2.5B's own kernels (its run in phase 4 launches them).
    for B in (1, M2_LANES, 16):
        check_moe_gemv(dev, records, B)
    for plen in (8064, 16256):
        check_moe_gemm(dev, records, M2_LANES * plen)
    check_flash_prefill_window(dev, records)
    check_window_insert(dev, records)
    torch.cuda.empty_cache()
    log(f"[phase2] done at {time.perf_counter() - t_start:.1f} s")

    in_situ = []
    in_situ_parity(dev, in_situ)
    in_situ_cli(dev, in_situ)
    trained_parity(dev, in_situ)
    in_situ_batch(dev, in_situ)
    in_situ_eval(dev, in_situ)
    quantize_on_card_matches_cpu(dev)
    log(f"[phase3] done at {time.perf_counter() - t_start:.1f} s")
    refs = end_to_end(dev, card, runs, profile=args.profile)
    log(f"[phase4] bench paths done at {time.perf_counter() - t_start:.1f} s")
    cli_full_run(dev, card, runs)
    log(f"[phase4] CLI run done at {time.perf_counter() - t_start:.1f} s")
    gptq_full_run(dev, card, runs)
    log(f"[phase4] GPTQ run done at {time.perf_counter() - t_start:.1f} s")
    int8_bench_run(dev, card, runs, profile=args.profile)
    C_eval = eval_full_run(dev, card, runs)
    log(f"[phase4] eval run done at {time.perf_counter() - t_start:.1f} s")
    # The eval's cache length is off the i8dot gate (C % 128 != 0): its
    # decode attention is the dequantizing kv8 pooled variant, held here at
    # that run's shape, with the fused insert beside it.
    gc.collect()
    torch.cuda.empty_cache()
    check_decode(dev, records, 8, True, C_eval, B=BATCH, from_run=EVAL_RUN)
    check_hh_evict_insert(dev, records, B=BATCH, C=C_eval, from_run=EVAL_RUN)
    gc.collect()
    torch.cuda.empty_cache()
    mellum2_run(dev, card, runs)
    log(f"[phase4] {M2_NAME} run done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    refs.update(bf16_reference(dev, card))
    parallel_phase(card, runs, refs)
    log(f"[phase6] phases 5 and 6 done at {time.perf_counter() - t_start:.1f} s")
    runs += in_situ
    return finish(records, runs, card, t_start)


def finish(records, runs, card, t_start) -> int:
    """The last three lines: the card, every kernel with its launches, and
    the result line."""
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
