"""``ops/decode_attn.py`` (K3/K5, ``decode_attn_kernel``): the least time of
every layer's decode attention (``roofline.decode_attention``) over its
kernel time in the traced decode parts."""

from portbench import roofline


def read(ctx):
    s = (ctx.trace or {}).get("kernels", {}).get("decode", {})
    t = sum(v[1] for n, v in s.items() if "decode_attn_kernel" in n)
    steps = sum(c["steps"] for c in ctx.trace["calls"]) if ctx.trace else 0
    if t <= 0 or not steps:
        return None
    least = roofline.decode_attention(ctx.d, ctx.B, ctx.C, ctx.cache_bits).seconds()
    return 100.0 * steps * ctx.d.n_layer * least / t
