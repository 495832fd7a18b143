#!/usr/bin/env python3
"""On-card smoke run of ``cold_compress_tpu_torch``, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

0. the card's name and power limit (``nvidia-smi``);
1. build the port's CUDA kernels from ``cold_compress_tpu_torch/csrc``
   (``nvcc``, sm_90a, one process per source, all at once);
2. each kernel against its plain PyTorch version on the card at the shapes
   of the Llama-3-8B main path, timed with CUDA events beside its bound;
3. small in-situ parity: the port on the card against the port on the CPU
   (plain versions), TestKernel with int4 weights, kv8 heavy-hitter cache,
   teacher-forced;
4. end to end at Llama-3-8B (32 layers, random int4 weights and head from
   seed 0, kv8 heavy_hitter cache at 25% of an 8192 context with the
   heavy_hitter prompt compressor, a 7928-token prompt, 128 greedy
   tokens), with the launch count of every kernel checked; with
   ``--profile``, then the wall and device time of a few decode steps.

The last three lines of standard output are the card's name and power
limit, one JSON object describing every kernel, and the result line.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
L2_BYTES = 50 * 2**20
REPO_TPU = "cold_compress_tpu"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_w4a8(dev, records):
    from cold_compress_tpu_torch.ops import qmm

    gs = 128
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = [  # (counter, IN, OUT, replaces)
        ("w4a8_gemv.wqkv", 4096, 6144, f"{REPO_TPU}/ops/pallas_qmm.py:712"),
        ("w4a8_gemv.wo", 4096, 4096, f"{REPO_TPU}/ops/pallas_qmm.py:712"),
        ("w4a8_gemv.w13", 4096, 28672, f"{REPO_TPU}/ops/pallas_qmm.py:712"),
        ("w4a8_gemv.w2", 14336, 4096, f"{REPO_TPU}/ops/pallas_qmm.py:712"),
        ("w4a8_gemv.head", 4096, 128256, f"{REPO_TPU}/ops/pallas_qmm.py:407"),
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

        ms = time_ms(lambda i: qmm.w4a8_gemv(x, ws[i % n], szs[i % n], gs, counter=name), 50)
        plain_ms = time_ms(lambda i: qmm.w4a8_gemv_plain(x, ws[i % n], szs[i % n], gs), 5, 1)
        b_ms, b_by = bound(nbytes, 2 * IN * OUT, "int8")
        log(f"[time] {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
            f"{nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms, library: none")
        records[name] = dict(
            name=name, route="cuda", source="cold_compress_tpu_torch/csrc/w4a8_gemv.cu",
            replaces=replaces, max_abs_err=err, tol="1e-4*max|ref| + 1e-6",
            max_err_over_tol=err / tol, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        )
        del ws, szs


def check_kv8_decode(dev, records):
    from cold_compress_tpu_torch.caches.base import quantize_rows
    from cold_compress_tpu_torch.ops import decode_attn

    B, H, KVH, C, D = 1, 32, 8, 2048, 128
    gen = torch.Generator(device=dev).manual_seed(2)
    nbytes = (2 * B * KVH * C * D + 4 * 4 * B * KVH * C + B * KVH * C
              + 2 * B * H * D + 2 * B * H * D + 4 * B * KVH * C)
    n = copies_for(nbytes)
    layers = []
    for _ in range(n):
        kq, ks, kz = quantize_rows(torch.randn((B, KVH, C, D), device=dev, generator=gen), 8)
        vq, vs, vz = quantize_rows(torch.randn((B, KVH, C, D), device=dev, generator=gen), 8)
        # Partly empty: a different fill per head, plus evicted holes.
        fill = torch.randint(C // 2, C, (B, KVH, 1), device=dev, generator=gen)
        mask = torch.arange(C, device=dev) < fill
        mask &= torch.rand((B, KVH, C), device=dev, generator=gen) > 0.05
        layers.append((kq, vq, ks, kz, vs, vz, mask))
    q = (torch.randn((B, H, 1, D), device=dev, generator=gen) / 4).to(torch.bfloat16)

    def run(i):
        kq, vq, ks, kz, vs, vz, mask = layers[i % n]
        return decode_attn.kv8_decode_attention(q, kq, vq, ks, kz, vs, vz, mask)

    out, pooled = run(0)
    kq, vq, ks, kz, vs, vz, mask = layers[0]
    ref_out, ref_pooled = decode_attn.kv8_decode_attention_plain(q, kq, vq, ks, kz, vs, vz, mask)
    torch.cuda.synchronize()
    # Same roundings on both sides; only the order of the f32 sums differs
    # (the kernel sums 128-slot chunks).
    err, ratio, tol = bf16_out_err(out, ref_out, 2**-8)
    err_p = max_err(pooled, ref_pooled)
    tol_p = 1e-5 * float(ref_pooled.max()) + 1e-8
    log(f"[check] kv8_decode_attention B={B} H={H} KVH={KVH} C={C}: out max_abs_err="
        f"{err:.3e}, max err/tol {ratio:.3f} (tol {tol}); pooled "
        f"max_abs_err={err_p:.3e} tol={tol_p:.3e}")
    assert ratio <= 1 and err_p <= tol_p, "kv8_decode_attention disagrees with its plain version"
    assert bool((pooled[~mask[:, :, None, :]] == 0).all()), "masked slots got probability"

    ms = time_ms(run, 200)
    plain_ms = time_ms(lambda i: decode_attn.kv8_decode_attention_plain(q, *layers[i % n]), 10)
    b_ms, b_by = bound(nbytes, 4 * B * H * C * D, "bf16")
    log(f"[time] kv8_decode_attention: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}), "
        f"plain {plain_ms:.3f} ms, library: none")
    records["kv8_decode_attention"] = dict(
        name="kv8_decode_attention", route="cuda",
        source="cold_compress_tpu_torch/csrc/kv8_decode_attn.cu",
        replaces=f"{REPO_TPU}/ops/pallas_decode_attn.py:899", max_abs_err=err,
        tol=tol, max_err_over_tol=ratio, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def check_flash_prefill(dev, records):
    from cold_compress_tpu_torch.ops import prefill_attn

    B, H, KVH, P, D, plen = 1, 32, 8, 8192, 128, 7928
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((B, H, P, D), device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn((B, KVH, P, D), device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn((B, KVH, P, D), device=dev, generator=gen).to(torch.bfloat16)

    y, summ = prefill_attn.flash_prefill(q, k, v, plen, need_summary=True)
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
    plain_ms = time_ms(lambda i: prefill_attn.flash_prefill_plain(q, k, v, plen), 2, 1)
    nbytes = 2 * (2 * B * H * P * D + 2 * B * KVH * P * D) + 2 * 4 * B * KVH * P
    pairs = B * H * P * (P + 1) // 2  # causal (query, key) pairs
    b_ms, b_by = bound(nbytes, 4 * D * pairs, "bf16")
    kr = k.repeat_interleave(H // KVH, dim=1)
    vr = v.repeat_interleave(H // KVH, dim=1)
    sdpa_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, is_causal=True), 5, 1)
    log(f"[time] flash_prefill_summary: {ms:.3f} ms (bound {b_ms:.3f} ms by {b_by}; "
        f"{4 * D * pairs / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, library: none "
        f"(scaled_dot_product_attention, causal y only, no summaries: {sdpa_ms:.3f} ms)")
    records["flash_prefill_summary"] = dict(
        name="flash_prefill_summary", route="cuda",
        source="cold_compress_tpu_torch/csrc/flash_prefill.cu",
        replaces=f"{REPO_TPU}/ops/pallas_prefill.py:167", max_abs_err=err,
        tol=tol, max_err_over_tol=ratio, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path through generate()
# ---------------------------------------------------------------------------

CACHE_KW = {
    "cache_strategy": ["heavy_hitter"],
    "max_cache_length": [0.25],
    "prompt_compression_strategy": ["heavy_hitter"],
    "global_tokens": 4,
    "recent_window": 10,
    "cache_bits": 8,
}


def build(name: str, seed: int, device: str, context: int):
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import init_caches
    from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params
    from cold_compress_tpu_torch.runtime.engine import (
        build_cache_specs, build_model, cache_compatibility, params_from_flat,
    )

    cfg = ModelConfig.from_name(name)
    cache_compatibility(CACHE_KW)
    flat = random_quantized_params(cfg, seed=seed, head_mode="int4")
    params = params_from_flat(flat, device)
    del flat
    model = build_model(cfg, params, device, max_positions=context)
    del params
    specs = build_cache_specs(cfg, CACHE_KW, context)
    caches = init_caches(cfg, specs, 1, torch.bfloat16, device=device)
    return cfg, model, caches


def in_situ_parity(dev):
    from cold_compress_tpu_torch.models.transformer import prefill
    from cold_compress_tpu_torch.runtime.generate import generate, reset_caches

    prompt = np.random.RandomState(0).randint(2, 500, size=300).tolist()
    forced = np.random.RandomState(1).randint(2, 500, size=8).tolist()
    tokens = prompt + [0] * (512 - len(prompt))
    runs = {}
    for device in (dev, "cpu"):
        _, model, caches = build("TestKernel", 0, device, 512)
        with torch.inference_mode():
            logits = prefill(model, caches, torch.tensor([tokens], device=device), len(prompt))
        seq, info, caches = generate(model, reset_caches(caches), prompt, 8,
                                     prefill_bucket=512, next_tokens=forced)
        assert seq == prompt + forced
        runs[device] = (logits[0].float().cpu().numpy(), np.asarray(info["emitted_probs"]),
                        np.asarray(info["final_probs"]), caches[0].pos.cpu().numpy())
    (l_g, e_g, f_g, pos_g), (l_c, e_c, f_c, pos_c) = runs[dev], runs["cpu"]
    # Prefill logits come before any eviction: only summation order and the
    # bf16 roundings that follow from it differ.
    gap_l = float(np.abs(l_g - l_c).max())
    tol_l = 2e-2 * float(l_c.max() - l_c.min())
    # Decode probabilities also carry the heavy-hitter evictions, which
    # follow near-ties of the history on random weights and so may pick
    # other slots on the card than on the CPU.
    gap = float(np.abs(e_g - e_c).max())
    gap_f = float(np.abs(f_g - f_c).max())
    tol = 5e-2 * float(e_c.max())
    log(f"[parity] TestKernel cuda vs cpu: prefill logits max gap {gap_l:.3e} (tol {tol_l:.3e}); "
        f"teacher-forced emitted_probs max gap {gap:.3e}, final_probs max gap {gap_f:.3e} "
        f"(tol {tol:.3e}); layer-0 kept positions equal: {float((pos_g == pos_c).mean()):.4f}")
    assert np.all(np.isfinite(l_g)) and gap_l <= tol_l
    assert np.all(np.isfinite(e_g)) and gap <= tol and gap_f <= tol


def profile_decode(model, caches, token: int, start_pos: int, steps: int, card: str):
    """Where a decode step's time goes: wall time per step without the
    profiler, and device time per step by kernel from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cold_compress_tpu_torch.models.transformer import decode_step

    def run(tok, pos):
        for i in range(steps):
            tok = decode_step(model, caches, tok, pos + i).argmax(-1)
        return tok

    tok = torch.tensor([token], device="cuda")
    with torch.inference_mode():
        tok = run(tok, start_pos)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = run(tok, start_pos + steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(tok, start_pos + 2 * steps)
            torch.cuda.synchronize()
    # Device-side events only (kernels, copies, fills): the host-side aten
    # rows carry the same device time again.
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    n_kernels = sum(e.count for e in rows) / steps
    log(f"[profile] decode step: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f}%), {n_kernels:.0f} device launches "
        f"per step  [{card}]")
    for e in rows[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{e.count / steps:6.1f}/step  {e.key[:90]}")


def end_to_end(dev, card, profile=False):
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.generate import generate, reset_caches

    context, new_tokens = 8192, 128
    t0 = time.perf_counter()
    cfg, model, caches = build("Meta-Llama-3-8B-Instruct", 0, dev, context)
    torch.cuda.synchronize()
    log(f"[e2e] Llama-3-8B built in {time.perf_counter() - t0:.1f} s: {cfg.n_layer} layers, "
        f"C={caches[0].spec.max_cache_length}, load peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    prompt_len = context - 256 - 8  # bench.py's prompt length
    prompt = np.random.RandomState(0).randint(5, cfg.vocab_size - 5, size=prompt_len).tolist()

    generate(model, caches, prompt, 8)  # warm-up: cuBLAS, allocator
    reset_caches(caches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    seq, info, caches = generate(model, caches, prompt, new_tokens)
    launches = kernel_launches()
    perf = info["perf_stats"]
    steps = perf["decode_steps"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[e2e] launches: {json.dumps(launches)}")
    log(f"[e2e] prefill {perf['prefill_seconds']:.4f} s for {prompt_len} tokens "
        f"({perf['prefill_toks_per_sec']:.1f} tok/s); decode {perf['decode_toks_per_sec']:.3f} "
        f"tok/s over {steps} steps; peak memory {peak_gb:.3f} GB  [{card}]")

    gen_tokens = seq[prompt_len:]
    assert steps == new_tokens - 1 and len(gen_tokens) == new_tokens
    assert all(0 <= t < cfg.vocab_size for t in gen_tokens)
    final = np.asarray(info["final_probs"])
    assert final.shape == (cfg.vocab_size,) and np.all(np.isfinite(final))
    assert abs(float(final.sum()) - 1.0) < 1e-3
    emitted = np.asarray(info["emitted_probs"])
    assert emitted.shape == (new_tokens,) and np.all((emitted > 0) & (emitted <= 1))
    for c in caches:
        assert int(c.cache_ct.min()) == c.spec.max_cache_length
        pos = c.pos[0].cpu().numpy()
        assert all(len(set(row.tolist())) == len(row) for row in pos), "duplicate positions"
        assert int(pos.max()) == prompt_len + new_tokens - 2  # last decoded token's slot

    want = {
        "w4a8_gemv.wqkv": cfg.n_layer * steps,
        "w4a8_gemv.wo": cfg.n_layer * steps,
        "w4a8_gemv.w13": cfg.n_layer * steps,
        "w4a8_gemv.w2": cfg.n_layer * steps,
        "w4a8_gemv.head": steps + 1,
        "kv8_decode_attention": cfg.n_layer * steps,
        "flash_prefill_summary": cfg.n_layer,
    }
    assert launches == want, f"routing witness: got {launches}, want {want}"
    if profile:
        profile_decode(model, caches, seq[-1], prompt_len + new_tokens, 8, card)
    return launches, perf, peak_gb


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the end-to-end run, profile a few decode steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card.",
              file=sys.stderr)
        return 2
    from cold_compress_tpu_torch.ops import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    card = card_line()
    log(f"[card] {card} | torch.cuda: {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels built in {time.perf_counter() - t0:.1f} s "
        f"into {_build.BUILD_INFO['dir']}")
    for name, text in _build.BUILD_INFO["logs"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    records = {}
    check_w4a8(dev, records)
    check_kv8_decode(dev, records)
    check_flash_prefill(dev, records)
    torch.cuda.empty_cache()

    in_situ_parity(dev)
    launches, perf, peak_gb = end_to_end(dev, card, profile=args.profile)

    kernels = []
    for name, rec in records.items():
        kernels.append({**rec, "launches": launches[name]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
