"""``ops/prefill_attn.py`` (K4/K6: ``flash_fwd_kernel``, ``colsum_kernel``,
``colsum_reduce``): the least time of every layer's causal attention with
its summaries over the prompts' true lengths (the architecture's
``prefill_attention_seconds``) over the kernels' time in the traced prefill
parts."""

KERNELS = ("flash_fwd_kernel", "colsum_kernel", "colsum_reduce")


def read(ctx):
    s = (ctx.trace or {}).get("kernels", {}).get("prefill", {})
    t = sum(v[1] for n, v in s.items() if any(k in n for k in KERNELS))
    least = getattr(ctx.arch, "prefill_attention_seconds", None)
    if t <= 0 or least is None:
        return None
    return 100.0 * sum(least(ctx.d, r["lens"]) for r in ctx.traced) / t
