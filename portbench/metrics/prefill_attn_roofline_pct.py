"""``ops/prefill_attn.py`` (K4/K6: ``flash_fwd_kernel``, ``colsum_kernel``,
``colsum_reduce``): the least time of every layer's causal attention with
its summaries over the prompts' true lengths
(``roofline.prefill_attention``) over the kernels' time in the traced
prefill parts."""

from portbench import roofline

KERNELS = ("flash_fwd_kernel", "colsum_kernel", "colsum_reduce")


def read(ctx):
    s = (ctx.trace or {}).get("kernels", {}).get("prefill", {})
    t = sum(v[1] for n, v in s.items() if any(k in n for k in KERNELS))
    if t <= 0:
        return None
    least = sum(roofline.prefill_attention(ctx.d, r["lens"]).seconds() for r in ctx.traced)
    return 100.0 * ctx.d.n_layer * least / t
