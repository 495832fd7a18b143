"""``ops/decode_attn.py`` (K3/K5, ``decode_attn_kernel``): the least time of
every layer's decode attention in a step (the architecture's
``decode_attention_seconds``) over its kernel time in the traced decode
parts."""


def read(ctx):
    s = (ctx.trace or {}).get("kernels", {}).get("decode", {})
    t = sum(v[1] for n, v in s.items() if "decode_attn_kernel" in n)
    steps = sum(c["steps"] for c in ctx.trace["calls"]) if ctx.trace else 0
    least = getattr(ctx.arch, "decode_attention_seconds", None)
    if t <= 0 or not steps or least is None:
        return None
    return 100.0 * steps * least(ctx.d, ctx.B, ctx.C, ctx.cache_bits) / t
