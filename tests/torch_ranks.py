"""Rank functions of the port's parallel CPU tests (``tests/test_torch_sp.py``).

Spawned ranks import a rank function's module by name, and a test module
imports JAX; this one imports only the port.
"""

import torch

from cold_compress_tpu_torch.models.transformer import decode_step, init_caches
from cold_compress_tpu_torch.parallel.mesh import make_context
from cold_compress_tpu_torch.parallel.pp import pp_prefill
from cold_compress_tpu_torch.parallel.sp import sp_prefill, sp_tp_prefill
from cold_compress_tpu_torch.parallel.tp_decode import build_rank_model
from cold_compress_tpu_torch.runtime.engine import params_from_flat


def prefill_and_decode(ctx, cfg, flat, specs, tokens, prompt_len: int, n_decode: int,
                       chunk: int = 32):
    """One rank's prefill under its layout (``sp_prefill``, ``sp_tp_prefill``
    or ``pp_prefill`` at ``chunk``) of ``tokens`` on the flat checkpoint's
    weights into f32 caches of ``specs``, then ``n_decode`` greedy steps of
    ``decode_step``. Returns (logits [1, vocab], each layer's cache after
    the prefill as a dict of arrays, the greedy tokens: the prefill's, then
    one per step)."""
    model = build_rank_model(cfg, params_from_flat(flat, "cpu"), ctx,
                             max_positions=cfg.block_size)
    caches = init_caches(model.cfg, specs, 1, torch.float32, device="cpu")
    ids = torch.tensor([tokens], dtype=torch.long)
    with torch.inference_mode():
        if model.pp is not None:
            logits = pp_prefill(model, caches, ids, prompt_len, chunk=chunk)
        elif model.tp is not None:
            logits = sp_tp_prefill(model, caches, ids, prompt_len)
        else:
            logits = sp_prefill(model, caches, ids, prompt_len)
        state = [{"pos": c.pos.numpy().copy(), "mask": c.mask.numpy().copy(),
                  "k": c.k.numpy().copy(), "v": c.v.numpy().copy(),
                  **({"strategy_idx": c.extra["strategy_idx"].numpy().copy()}
                     if "strategy_idx" in c.extra else {})} for c in caches]
        tok = logits.argmax(dim=-1)
        toks = [int(tok)]
        for i in range(n_decode):
            tok = decode_step(model, caches, tok, prompt_len + i).argmax(dim=-1)
            toks.append(int(tok))
    return logits.numpy(), state, toks


def context_error(ctx, layout):
    """The message of the error this rank's context of ``layout`` raises
    (every rank of the world asks), or None where it builds one."""
    try:
        make_context(layout, ctx.device)
    except ValueError as e:
        return str(e)
    return None
