"""95th percentile over every request of its mean gap between output
tokens: its call's decode seconds over its decode steps, in ms."""

import numpy as np


def read(ctx):
    gaps = [1e3 * r["decode_s"] / r["steps"] for r in ctx.records for _ in r["lens"]
            if r["steps"]]
    return float(np.percentile(gaps, 95)) if gaps else None
