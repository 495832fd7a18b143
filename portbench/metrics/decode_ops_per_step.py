"""Device operations per decode step (``runtime/cuda_graph.py``'s replayed
step, ``models``, ``caches``, and the loop's stop read): every device
operation of the traced decode parts over their steps."""


def read(ctx):
    t = ctx.trace or {}
    steps = sum(c["steps"] for c in t.get("calls", []))
    n = sum(v[0] for v in t.get("kernels", {}).get("decode", {}).values())
    return n / steps if steps and n else None
