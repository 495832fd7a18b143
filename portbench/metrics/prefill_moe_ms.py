"""``models/transformer.py``'s expert layer at prefill: the device ms of
the program's ``prefill.moe`` spans (router, dispatch, experts, combine;
``runtime/trace.py``) per call of the traced round. None where the program
has no such span."""


def read(ctx):
    spans = ctx.spans or []
    calls = {r["call"] for r in spans if r["name"] == "generate.prefill" and r["device"]}
    moe = [r["device"][1] - r["device"][0] for r in spans
           if r["name"] == "prefill.moe" and r["device"]]
    if not calls or not moe:
        return None
    return 1e-6 * sum(moe) / len(calls)
