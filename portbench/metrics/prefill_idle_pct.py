"""Share of the traced prefill parts in which no device operation runs: one
less their device-busy time over their length, both on the trace's clock
(``portbench/trace.py``). The run prints beside it how much the profiler
slows a prefill against the untraced window."""


def read(ctx):
    calls = (ctx.trace or {}).get("calls", [])
    span = sum(c["prefill_s"] for c in calls)
    busy = sum(c["prefill_busy_s"] for c in calls)
    if busy <= 0 or span <= 0:
        return None  # no device operation was traced
    return 100.0 * (1.0 - busy / span)
