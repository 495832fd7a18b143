"""``runtime/generate.py::generate_batch``'s lanes: tokens emitted over the
lanes times the tokens each call could emit (its decode steps plus the
first token), over the window's calls (the program's counts)."""


def read(ctx):
    slots = sum(len(r["lens"]) * (r["steps"] + 1) for r in ctx.records)
    return 100.0 * sum(sum(r["emitted"]) for r in ctx.records) / slots if slots else None
