"""``ops/qmm.py``'s decode GEMVs (K1/K2, ``w4a8_gemv_kernel``): the sum of
their least times (``roofline.gemv`` per projection) over the sum of their
kernel times in the traced decode parts."""

from portbench import roofline


def read(ctx):
    s = (ctx.trace or {}).get("kernels", {}).get("decode", {})
    t = sum(v[1] for n, v in s.items() if "w4a8_gemv_kernel" in n)
    steps = sum(c["steps"] for c in ctx.trace["calls"]) if ctx.trace else 0
    if t <= 0 or not steps:
        return None
    d = ctx.d
    per_step = sum(roofline.gemv(d, ctx.B, i, o).seconds()
                   for i, o in roofline.layer_linears(d)) * d.n_layer
    per_step += roofline.gemv(d, ctx.B, d.dim, d.vocab).seconds()
    return 100.0 * steps * per_step / t
