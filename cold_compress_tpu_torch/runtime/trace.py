"""Spans of the generate path, on the host's clock and, where a span
brackets work on the card, on the card's clock mapped onto the host's.

Off by default. ``span()`` then returns one shared context that does
nothing, after one check of a module flag: no CUDA event, no
``record_function``, no synchronisation. ``start()`` turns the tracer on
and ``stop()`` turns it off and returns the records; it resolves every
CUDA event then, never while spans are being recorded.

Each record is a dict:

* ``name``, ``attrs`` (the span's keyword arguments, and what ``set`` adds);
* ``id`` (its index in the records), ``parent`` (the enclosing span's id,
  or None) and ``call`` (the id of the outermost enclosing span, itself for
  a root: every span of one ``generate``/``generate_batch`` call shares its
  ``generate.call`` span's id);
* ``host``: ``[start, end]`` in ``time.perf_counter_ns()``;
* ``device``: for a span opened with ``device=True`` while the tracer
  records CUDA events, ``[start, end]`` of two events recorded on the
  current stream at its entry and exit, in ns on the host's clock; else
  None. ``start()`` synchronises once and records an anchor event at a
  known ``perf_counter_ns``; each event's time is the anchor's plus the
  card's elapsed time to it, taken event to event in the order they were
  recorded. No event is recorded while the current stream is being
  captured, so a captured graph is the same with the tracer on or off.

With ``ranges=True`` each span also opens a
``torch.profiler.record_function`` of its name, so that the spans appear in
a profiler's trace, on the profiler's clock.

The spans (where they are opened, which bracket device work, what reads
them): ``generate.call`` (``runtime/generate.py``: lanes, prompt lengths,
bucket, steps); ``generate.prefill`` and ``generate.decode`` (the two
phases ``perf_stats`` times, device); ``prefill.linear`` (each projection
of a prefill and its head, ``models/transformer.py``, device);
``prefill.moe`` (a mixture of experts' router, dispatch, experts and
combine, ``models/transformer.py::moe_forward``, device; its projections
are not in ``prefill.linear``); ``prefill.attn`` (K4/K6 or their plain
versions, device); ``prefill.cache``
(compression and the cache fill, device); ``decode.step`` (one step of
``decode_loop_core``: device events just before and after the replay);
``decode.launch`` (the graph's launch, host); ``decode.stop_read`` (the
per-step read of the stop flags, host); ``decode.capture`` (a capture of
the decode graph, host, with its seconds). ``decode_readings`` and
``prefill_readings`` reduce them; ``log_lines`` prints both.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

_on = False
_tracer: Optional["_Tracer"] = None
#: CUDA events with timing, reused from one ``start()`` to the next.
_POOL: List[torch.cuda.Event] = []


class _Off:
    """The span returned while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Tracer:
    """The spans recorded so far, column by column: the columns hold ints
    and strings (and an attribute dict where a span has attributes), so
    recording adds no container for the garbage collector to walk."""

    def __init__(self, ranges: bool, cuda: bool):
        self.ranges = ranges
        self.cuda = cuda
        self.name: List[str] = []
        self.parent: List[Optional[int]] = []
        self.call: List[int] = []
        self.attrs: List[Optional[dict]] = []
        self.t0: List[int] = []
        self.t1: List[int] = []
        self.stack: List[int] = []  # the open spans' ids
        self.events: List[torch.cuda.Event] = []  # in recording order
        self.slots: List[int] = []  # per event: 2 * span id + (0 at entry, 1 at exit)
        # ``torch.cuda.current_stream()`` builds a Stream object (7.5 us on
        # an H100 machine's host, where the card waits ~0.1 ms between
        # decode steps): each stream's object is kept by its raw handle.
        self.streams: Dict[int, torch.cuda.Stream] = {}
        self.anchor = None
        self.anchor_ns = 0
        if cuda:
            self.anchor, self.anchor_ns = self.anchor_event()

    def anchor_event(self):
        """An event recorded on the idle card, and the host's clock then."""
        torch.cuda.synchronize()
        ev = self.event()
        t = time.perf_counter_ns()
        ev.record()
        torch.cuda.synchronize()
        return ev, t

    def event(self) -> torch.cuda.Event:
        n = len(self.events) + (self.anchor is not None)
        if n == len(_POOL):
            _POOL.append(torch.cuda.Event(enable_timing=True))
        return _POOL[n]

    def record(self, slot: int) -> None:
        """An event on the current stream at a span's entry or exit."""
        raw = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        stream = self.streams.get(raw)
        if stream is None:
            stream = self.streams[raw] = torch.cuda.current_stream()
        ev = self.event()
        ev.record(stream)
        self.events.append(ev)
        self.slots.append(slot)

    def records(self) -> List[dict]:
        """The records. With CUDA each event's time is the card's elapsed
        time from the first anchor, chained event to event (each link a
        short interval, so the card's f32 milliseconds lose nothing over a
        long trace), laid onto the host's clock between the first anchor
        and one recorded now (the two clocks drift apart by a few parts
        per million: ~0.5 ms over 160 s on the H100 machine)."""
        device: List[list] = [None] * len(self.name)
        if self.cuda:
            end, end_ns = self.anchor_event()
            prev, t, times = self.anchor, 0.0, []
            for ev in self.events + [end]:
                t += prev.elapsed_time(ev) * 1e6
                prev = ev
                times.append(t)
            scale = (end_ns - self.anchor_ns) / t if t > 0 else 1.0
            for d, slot in zip(times, self.slots):
                ns = self.anchor_ns + round(d * scale)
                if slot & 1:
                    device[slot >> 1].append(ns)
                else:
                    device[slot >> 1] = [ns]
        return [{"name": self.name[i], "id": i, "parent": self.parent[i], "call": self.call[i],
                 "attrs": self.attrs[i] or {}, "host": [self.t0[i], self.t1[i]],
                 "device": device[i]} for i in range(len(self.name))]


class _Span:
    __slots__ = ("_tracer", "_id", "_device", "_range")

    def __init__(self, tracer: _Tracer, name: str, device: bool, attrs: dict):
        self._tracer = tracer
        self._id = i = len(tracer.name)
        self._device = device and tracer.cuda
        self._range = None
        parent = tracer.stack[-1] if tracer.stack else None
        tracer.name.append(name)
        tracer.parent.append(parent)
        tracer.call.append(i if parent is None else tracer.call[parent])
        tracer.attrs.append(attrs or None)
        tracer.t0.append(0)
        tracer.t1.append(0)

    def __enter__(self):
        tr, i = self._tracer, self._id
        tr.stack.append(i)
        if tr.ranges:
            self._range = torch.profiler.record_function(tr.name[i])
            self._range.__enter__()
        tr.t0[i] = time.perf_counter_ns()
        if self._device and torch.cuda.is_current_stream_capturing():
            self._device = False
        if self._device:
            tr.record(2 * i)
        return self

    def __exit__(self, *exc):
        tr, i = self._tracer, self._id
        if self._device:
            tr.record(2 * i + 1)
        tr.t1[i] = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        tr.stack.pop()
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the span has run."""
        tr, i = self._tracer, self._id
        if tr.attrs[i] is None:
            tr.attrs[i] = {}
        tr.attrs[i].update(attrs)


def span(name: str, device: bool = False, **attrs):
    """A context manager that records the span ``name`` while the tracer
    is on (``device``: with CUDA events at its entry and exit); a shared
    no-op otherwise."""
    if not _on:
        return _OFF
    return _Span(_tracer, name, device, attrs)


def start(ranges: bool = False, cuda: Optional[bool] = None) -> None:
    """Turn the tracer on. ``ranges``: each span also opens a profiler
    range. ``cuda`` (default: whether a card is available): spans opened
    with ``device=True`` record CUDA events on the current stream; pass
    False where the traced work runs on the CPU."""
    global _on, _tracer
    if _on:
        raise RuntimeError("the tracer is already on")
    _tracer = _Tracer(ranges, torch.cuda.is_available() if cuda is None else cuda)
    _on = True


def stop() -> List[dict]:
    """Turn the tracer off and return its records, every device interval
    resolved (this synchronises). Call it with no span open."""
    global _on, _tracer
    tr, _on, _tracer = _tracer, False, None
    return [] if tr is None else tr.records()


@contextlib.contextmanager
def profiled(on: bool, cuda: bool):
    """``torch.profiler`` over the block (CPU activity, and CUDA's with
    ``cuda``), with the tracer on and each span a range of the profile (the
    profile times the card: the spans record no CUDA events); yields the
    profile. With ``on`` false it yields None and neither runs."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        start(ranges=True, cuda=False)
        try:
            yield prof
        finally:
            stop()


# ---------------------------------------------------------------------------
# Readings
# ---------------------------------------------------------------------------


def _dur(rec) -> int:
    return rec["device"][1] - rec["device"][0]


def decode_readings(records: List[dict]) -> Optional[Dict[str, float]]:
    """Over every ``generate.decode`` span with device times and the
    ``decode.step`` spans inside it: ``decode_gap_pct`` (the card's time
    between a step's end event and the next step's start event, summed,
    over the decode spans' device length, in %), ``decode_graph_ms_per_step``
    (the median step's device time, end event less start event),
    ``decode_step_p99_ms`` (the 99th percentile of the time from one step's
    end event to the next's), ``steps``, and per step on average: ``gap_ms``
    split into ``stop_read_ms`` (the part of the gap the host spent in the
    stop read) and ``loop_ms`` (the rest), and ``launch_ms`` (the host's
    graph launch, which lies inside the step). None without device times."""
    decode = {r["id"]: r for r in records if r["name"] == "generate.decode" and r["device"]}
    children: Dict[int, List[dict]] = {i: [] for i in decode}
    for r in records:
        if r["parent"] in children:
            children[r["parent"]].append(r)
    step_ids = {r["id"] for rs in children.values() for r in rs if r["name"] == "decode.step"}
    launches = sum(r["host"][1] - r["host"][0] for r in records
                   if r["name"] == "decode.launch" and r["parent"] in step_ids)
    times, gaps, step_ends, in_read = [], [], [], 0
    for rs in children.values():
        prev, read = None, None  # the last step, and the stop read after it
        for r in rs:
            if r["name"] == "decode.stop_read":
                read = r
            elif r["name"] == "decode.step" and r["device"]:
                times.append(_dur(r))
                if prev is not None:
                    g0, g1 = prev["device"][1], r["device"][0]
                    gaps.append(g1 - g0)
                    step_ends.append(r["device"][1] - g0)
                    if read is not None:
                        in_read += max(0, min(g1, read["host"][1]) - max(g0, read["host"][0]))
                prev, read = r, None
    n = len(times)
    if not n:
        return None
    length = sum(_dur(r) for r in decode.values())
    gap = float(sum(gaps))
    return {
        "decode_gap_pct": 100.0 * gap / length,
        "decode_graph_ms_per_step": float(np.median(times)) * 1e-6,
        "decode_step_p99_ms": float(np.percentile(step_ends, 99)) * 1e-6 if step_ends else None,
        "steps": n,
        "gap_ms": gap / n * 1e-6,
        "stop_read_ms": in_read / n * 1e-6,
        "loop_ms": (gap - in_read) / n * 1e-6,
        "launch_ms": launches / n * 1e-6,
    }


PREFILL_PARTS = ("linear", "moe", "attn", "cache")


def prefill_readings(records: List[dict]) -> Optional[Dict[str, float]]:
    """Over every call's ``generate.prefill`` span with device times:
    ``prefill_linear_ms`` and ``prefill_cache_ms`` (the median call's
    device ms in its ``prefill.linear`` / ``prefill.cache`` spans),
    ``calls``, and per call on average the prefill's device ms (``whole_ms``)
    split into ``linear_ms``, ``moe_ms`` (experts; only where the model
    has them), ``attn_ms``, ``cache_ms`` and ``rest_ms`` (the whole less the
    four: norms, rope, the embedding, the head's norm and softmax, and the
    card's idle time). None without device times."""
    whole = {r["call"]: _dur(r) for r in records
             if r["name"] == "generate.prefill" and r["device"]}
    if not whole:
        return None
    parts = {c: dict.fromkeys(PREFILL_PARTS, 0) for c in whole}
    for r in records:
        kind = r["name"].removeprefix("prefill.")
        if r["call"] in parts and kind in PREFILL_PARTS and r["device"]:
            parts[r["call"]][kind] += _dur(r)
    n = len(whole)
    out = {"prefill_linear_ms": float(np.median([p["linear"] for p in parts.values()])) * 1e-6,
           "prefill_cache_ms": float(np.median([p["cache"] for p in parts.values()])) * 1e-6,
           "calls": n, "whole_ms": sum(whole.values()) / n * 1e-6}
    for k in PREFILL_PARTS:
        out[f"{k}_ms"] = sum(p[k] for p in parts.values()) / n * 1e-6
    out["rest_ms"] = out["whole_ms"] - sum(out[f"{k}_ms"] for k in PREFILL_PARTS)
    if not out["moe_ms"]:  # a model without experts
        del out["moe_ms"]
    return out


def log_lines(records: List[dict]) -> List[str]:
    """The decode gap per step split by the host's spans, and the
    prefill's device time per call split by its parts; nothing without
    device times."""
    lines = []
    d = decode_readings(records)
    if d:
        lines.append(
            f"decode gap per step (CUDA events, {d['steps']} steps): {d['gap_ms']!r} ms of "
            f"{d['decode_graph_ms_per_step']!r} ms replayed (median), {d['decode_gap_pct']!r}% "
            f"of decode; the host in the gap: stop read {d['stop_read_ms']!r} ms, loop "
            f"{d['loop_ms']!r} ms; launch (inside the step) {d['launch_ms']!r} ms")
    p = prefill_readings(records)
    if p:
        lines.append(
            f"prefill device ms per call (CUDA events, {p['calls']} calls): {p['whole_ms']!r} = "
            f"linear {p['linear_ms']!r} + "
            + (f"experts {p['moe_ms']!r} + " if "moe_ms" in p else "")
            + f"attention {p['attn_ms']!r} + cache {p['cache_ms']!r} + rest {p['rest_ms']!r}")
    return lines
