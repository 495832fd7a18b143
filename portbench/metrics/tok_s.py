"""Tokens generated in every lane over all the time of the window (host
clock; the loop is closed, the window runs whole calls)."""


def read(ctx):
    return sum(sum(r["emitted"]) for r in ctx.records) / ctx.window_s
