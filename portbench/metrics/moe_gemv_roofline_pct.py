"""``ops/moe.py``'s grouped expert GEMV (``moe_w4a8_gemv_kernel``, both
launches of every layer): its least time in a step at the distinct experts
the program read (the architecture's ``moe_gemv_seconds``, at the card's
bytes rate: each distinct expert's int4 leaves once), over its kernel time
in the traced decode parts. The distinct experts a layer and step are the
program's device counter (``moe_gemv.experts.<layer>`` in the traced
round's launches) over the round's decode steps and the layers."""


def read(ctx):
    s = (ctx.trace or {}).get("kernels", {}).get("decode", {})
    t = sum(v[1] for n, v in s.items() if "moe_w4a8_gemv_kernel" in n)
    steps = sum(c["steps"] for c in ctx.trace["calls"]) if ctx.trace else 0
    least = getattr(ctx.arch, "moe_gemv_seconds", None)
    reads = sum(n for k, n in (ctx.launches or {}).items() if k.startswith("moe_gemv.experts."))
    traced_steps = sum(r["steps"] for r in ctx.traced)
    if t <= 0 or not steps or least is None or not reads or not traced_steps:
        return None
    distinct = reads / (traced_steps * ctx.d.n_layer)
    return 100.0 * steps * least(ctx.d, ctx.B, distinct) / t
