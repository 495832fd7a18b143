"""Process start to window start: imports, weights made on the device, the
model built (the program's int4 repack), kernels loaded or built, one warm
call per prefill bucket the mix uses, and the decode graph's capture."""


def read(ctx):
    return ctx.setup_s
