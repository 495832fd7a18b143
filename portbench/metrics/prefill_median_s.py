"""Median over the window's calls of the program's prefill seconds
(``perf_stats["prefill_seconds"]``): the prefill layer's time, steadier
than the 95th percentile of ``ttft_p95_s``, which with a window of few
calls is its slowest call."""

import numpy as np


def read(ctx):
    return float(np.median([r["prefill_s"] for r in ctx.records])) if ctx.records else None
