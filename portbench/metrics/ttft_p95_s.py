"""95th percentile over every request of its time to first token: its
call's ``perf_stats["prefill_seconds"]``, the program's synchronized host
clock up to the host's read of the first token's probabilities (a batch's
lanes share their call's)."""

import numpy as np


def read(ctx):
    return float(np.percentile([r["prefill_s"] for r in ctx.records for _ in r["lens"]], 95))
