"""The whole prefill's least time at the card's peaks (the architecture's
``prefill`` over the prompts' true lengths) over the window's measured
prefill seconds (the program's ``perf_stats``, untraced)."""


def read(ctx):
    if not ctx.on_card:
        return None  # a share of the card's peak needs the card
    span = sum(r["prefill_s"] for r in ctx.records)
    if span <= 0:
        return None
    return 100.0 * sum(ctx.arch.prefill(ctx.d, r["lens"]).seconds() for r in ctx.records) / span
