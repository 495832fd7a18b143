"""Device time per decode step in operations that are not the port's own
``csrc/`` kernels: norms, rope, the cache update, the eviction's
bookkeeping, softmax and argmax, copies. In ms."""

PORT_KERNELS = ("w4a8_gemv_kernel", "w8a8_gemv_kernel", "decode_attn_kernel", "hh_evict_kernel",
                "flash_fwd_kernel", "colsum_kernel", "colsum_reduce", "w4a8_quant_kernel",
                "w4a8_gemm_kernel")


def read(ctx):
    t = ctx.trace or {}
    steps = sum(c["steps"] for c in t.get("calls", []))
    ops = t.get("kernels", {}).get("decode", {})
    if not steps or not ops:
        return None
    glue = sum(v[1] for n, v in ops.items() if not any(k in n for k in PORT_KERNELS))
    return 1e3 * glue / steps
