"""The traced run: ``torch.profiler``'s record of a bounded span of calls,
reduced in memory to what the per-layer readers need.

The harness wraps each call in a ``portbench.call`` range. Within a call,
everything before the host's first ``cudaGraphLaunch`` is the prefill part
(the prompt's forward pass, compression, the cache fill and the read of the
first token) and everything from it to the call's end is the decode part
(one graph launch per step, the per-step stop read, the final read). For
each part the summary keeps its length, the time in which some device
operation ran, the steps, and the device operations by name. No trace file
is written.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List

import torch

CALL = "portbench.call"
GRAPH_LAUNCH = "cudaGraphLaunch"


class Profile:
    """``torch.profiler`` over a ``with`` block, CPU and (on a card) CUDA
    activity; ``events`` are then the profiler's raw records, read without
    building ``FunctionEvent``s, which a long decode makes slow."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        self.events = self._prof.profiler.kineto_results.events()
        return False


def _span(e):
    start = e.start_ns()
    return start, start + e.duration_ns()


def _busy(intervals: List[tuple], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) covered by sorted intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(events, top: int = 10) -> Dict:
    """The per-call parts, device operations by part and name, and the
    window's busy time, longest device operations and idle gaps."""
    device, host, calls, launches = [], [], [], []
    for e in events:
        name = e.name()
        s, t = _span(e)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", lambda: False)() or name.startswith("portbench."):
                continue
            device.append((s, t, name))
        elif name == CALL:
            calls.append((s, t))
        else:
            if name == GRAPH_LAUNCH:
                launches.append(s)
            host.append((s, t, name))
    device.sort()
    calls.sort()
    launches.sort()
    spans = [(s, t) for s, t, _ in device]
    out_calls = []
    kernels = {"prefill": defaultdict(lambda: [0, 0.0]), "decode": defaultdict(lambda: [0, 0.0])}
    for c0, c1 in calls:
        i = bisect.bisect_left(launches, c0)
        j = bisect.bisect_right(launches, c1)
        mid = launches[i] if i < j else c1
        parts = {"prefill": (c0, mid), "decode": (mid, c1) if i < j else None}
        rec = {"steps": j - i}
        for part, rng in parts.items():
            if rng is None:
                rec[f"{part}_s"] = rec[f"{part}_busy_s"] = 0.0
                continue
            lo, hi = rng
            a = bisect.bisect_left(spans, (lo, lo))
            b = bisect.bisect_left(spans, (hi, hi))
            for s, t, name in device[a:b]:
                k = kernels[part][name]
                k[0] += 1
                k[1] += (t - s) * 1e-9
            rec[f"{part}_s"] = (hi - lo) * 1e-9
            rec[f"{part}_busy_s"] = _busy(spans[a:b], lo, hi) * 1e-9
        out_calls.append(rec)
    summary = {"calls": out_calls,
               "kernels": {p: {n: list(v) for n, v in k.items()} for p, k in kernels.items()}}
    if not calls:
        return summary
    win0, win1 = calls[0][0], calls[-1][1]
    summary["window_s"] = (win1 - win0) * 1e-9
    summary["busy_s"] = _busy(spans, win0, win1) * 1e-9
    summary["breakdown"] = _breakdown(device, host, win0, win1, top)
    return summary


def _breakdown(device, host, win0: int, win1: int, top: int) -> Dict:
    """The device operations that took most time, and the idle gaps of the
    device by the innermost host operation running at each gap's middle."""
    by_name = defaultdict(float)
    for s, t, name in device:
        if s >= win0 and t <= win1:
            by_name[name[:200]] += (t - s) * 1e-9
    host.sort()
    starts = [s for s, _, _ in host]
    gaps = defaultdict(float)
    cur = win0
    for s, t, _ in device + [(win1, win1, "")]:
        s, t = max(s, win0), min(t, win1)
        if s > cur:
            m = (cur + s) // 2
            k = bisect.bisect_right(starts, m)
            inner = None
            for hs, he, hn in reversed(host[max(0, k - 16):k]):
                if he >= m and (inner is None or he - hs < inner[1] - inner[0]):
                    inner = (hs, he, hn)
            gaps[inner[2][:200] if inner else "(no host operation)"] += (s - cur) * 1e-9
        cur = max(cur, t)
    rank = lambda d: [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_name), "idle_gaps": rank(gaps)}
