"""``ops/qmm.py``'s decode GEMVs (K1/K2, ``w4a8_gemv_kernel``): the sum of
their least times in a step (the architecture's ``decode_gemv_seconds``,
each projection at its own bound) over the sum of their kernel times in the
traced decode parts."""


def read(ctx):
    s = (ctx.trace or {}).get("kernels", {}).get("decode", {})
    t = sum(v[1] for n, v in s.items() if "w4a8_gemv_kernel" in n)
    steps = sum(c["steps"] for c in ctx.trace["calls"]) if ctx.trace else 0
    least = getattr(ctx.arch, "decode_gemv_seconds", None)
    if t <= 0 or not steps or least is None:
        return None
    return 100.0 * steps * least(ctx.d, ctx.B) / t
