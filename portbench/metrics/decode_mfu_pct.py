"""The whole decode step's least time at the card's peaks (the
architecture's ``decode_step``: the larger of its operations and its bytes)
over the measured step: the window's decode seconds over its decode steps
(the program's ``perf_stats``, untraced)."""


def read(ctx):
    if not ctx.on_card:
        return None  # a share of the card's peak needs the card
    steps = sum(r["steps"] for r in ctx.records)
    span = sum(r["decode_s"] for r in ctx.records)
    if not steps or span <= 0:
        return None
    least = ctx.arch.decode_step(ctx.d, ctx.B, ctx.C, ctx.cache_bits).seconds()
    return 100.0 * steps * least / span
