"""Generation runtime: prefill, then a greedy decode loop on the device.

Counterpart of ``cold_compress_tpu/runtime/generate.py`` (single-prompt
``generate``, batched ``generate_batch``, ``decode_loop_core`` and
``reset_caches``). The JAX package
runs the decode loop as one jitted ``lax.while_loop``. Here one step of it
(``_decode_body``, the JAX ``body``: ``decode_step`` over every layer, the
softmax, greedy or teacher-forced selection, the recorded token and
probability, ``last_probs`` and ``done``) writes every result in place into
static device buffers (``cuda_graph.LoopBuffers``). On the card the step is
captured once as a CUDA graph and replayed once per token
(``runtime/cuda_graph.py``; ``generate(..., cuda_graph=False)`` runs it
eagerly instead); on the CPU it runs eagerly. The host reads the tokens
once at the end. With terminators given, it also reads whether every lane
is done after each step that was not teacher-forced (one sync per step) and
stops there, as the JAX loop's ``cond`` does: the caches then hold what the
reference's hold. A finished lane records nothing more (``-1`` tokens,
``0`` probabilities), which is what the JAX loop returns.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..caches import reset_state
from ..models.transformer import Transformer, decode_step, prefill
from . import engine
from .cuda_graph import LoopBuffers, decode_graph


def bucket_length(n: int, minimum: int = 16) -> int:
    """Round up to a power of two (the prefill length bucket)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _prefill_bucket(specs, n: int, prefill_bucket: Optional[int]) -> int:
    """The prefill bucket for a longest prompt of ``n`` tokens:
    ``prefill_bucket`` or n's power of two, capped by the smallest
    direct-fill cache (full, hybrid, and the full outer cache of debug_*),
    which writes all P padded slots."""
    direct_fill = [
        s.max_cache_length for s in specs
        if s.cache_strategy in ("full", "hybrid") or s.cache_strategy.startswith("debug_")
    ]
    P = prefill_bucket or bucket_length(n)
    if direct_fill and P > min(direct_fill):
        P = min(direct_fill)
        if P < n:
            raise ValueError(
                f"Prompt ({n} tokens) exceeds the smallest direct-fill cache length ({P}).")
    return P


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _use_graph(model: Transformer, cuda_graph: Optional[bool]) -> bool:
    """Whether this call decodes through the captured graph: by default on
    the card unless the model's tensor-parallel collectives cannot be
    captured (gloo's run on the host); asking for the graph there, or on the
    CPU, raises."""
    device = model.device
    capturable = model.tp is None or model.tp.capturable
    if cuda_graph is None:
        return device.type == "cuda" and capturable
    if cuda_graph and device.type != "cuda":
        raise ValueError("cuda_graph needs the model on a CUDA device")
    if cuda_graph and not capturable:
        raise ValueError(f"{model.tp.backend} collectives cannot be captured in a CUDA graph; "
                         "pass cuda_graph=False")
    return cuda_graph


def generate(
    model: Transformer,
    caches,
    prompt: Sequence[int],
    max_new_tokens: int,
    *,
    next_tokens: Optional[Sequence[int]] = None,
    terminator_ids: Optional[Sequence[int]] = None,
    feed_long_prompts: bool = False,
    decode_first_token: bool = False,
    min_cache_length: Optional[int] = None,
    pad_id: int = 0,
    prefill_bucket: Optional[int] = None,
    attn_top_k: float = 1.0,
    cuda_graph: Optional[bool] = None,
) -> Tuple[List[int], Dict[str, Any], Any]:
    """Generate greedily from a prompt; returns ``(sequence, info, caches)``.

    The caches (one ``CacheState`` per layer, on the model's device) are
    updated in place. Edge cases follow the JAX package:

    * ``next_tokens``: teacher forcing; every step emits the given token and
      records its probability.
    * ``feed_long_prompts``: a prompt longer than ``min_cache_length - 1``
      (by default the smallest cache's length) prefills its first
      ``min_cache_length - 1`` tokens and feeds the rest through the decode
      loop as forced tokens, one per step.
    * a prompt exactly as long as ``min_cache_length`` feeds its last token
      through decode, so eviction state exists before the cache overflows.
    * ``decode_first_token``: the last prompt token goes through decode.
    * ``pad_id`` fills the prefill bucket past the prompt.
    * ``terminator_ids``: a lane records nothing after emitting one.
    * ``attn_top_k < 1``: decode attention sums values over only that share
      of the top-scored cache slots (``decode_step``).
    * ``cuda_graph``: decode through a captured CUDA graph of one step
      (the default on the card; ``False`` runs the same step eagerly). A
      capture or replay that fails raises.

    A rank's tensor-parallel shard (``parallel/tp_decode.py::build_tp_model``)
    holds its ``TpContext`` as ``model.tp``, the JAX package's ``tp_ctx``:
    every rank of the tp group calls ``generate`` with the same arguments
    and gets the same tokens (each argmaxes the same gathered logits). One
    prompt takes dp = 1. Over gloo the graph cannot be captured: decode is
    eager and ``cuda_graph=True`` raises. A rank of a sequence-parallel
    (``model.sp``, the JAX package's ``sp_mesh``) or pipeline-parallel
    (``model.pp``, ``pp_mesh``) layout prefills through ``parallel/sp.py``
    (the bucket rounded up to a multiple of sp) or ``parallel/pp.py``
    (chunks of ``min(64, P)`` rows), every rank with the same arguments;
    its caches then hold what the single card's hold, and decode runs on
    each rank as on one card (over its tp group under sp x tp).

    ``info`` holds ``perf_stats`` (seconds and tokens per second, timed
    with the device synchronised; a call that captures the graph counts
    the capture in its decode time), ``emitted_probs`` (the probability of
    each emitted or forced token), ``final_probs`` (the last step's
    distribution over the vocabulary) and ``decode_graph`` (None when
    eager; else whether this call captured, the capture's seconds, the
    graph pool's bytes and the kernel launches of one replay).
    """
    device = model.device
    cuda_graph = _use_graph(model, cuda_graph)
    if model.tp is not None and model.tp.dp > 1:
        raise ValueError("generate() runs one prompt: dp must be 1 (generate_batch shards "
                         "lanes over dp)")
    cfg = model.cfg
    prompt = [int(t) for t in prompt]
    prompt_length = len(prompt)
    terminator_ids = [int(t) for t in (terminator_ids or [])]
    specs = [c.spec for c in caches]

    min_cache_length = min_cache_length or engine.min_cache_length(specs)
    max_prompt_len = min_cache_length - 1
    prefix: List[int] = []
    if (feed_long_prompts and prompt_length > max_prompt_len) or (
            prompt_length == min_cache_length):
        prompt, prefix = prompt[:max_prompt_len], prompt[max_prompt_len:]
        max_new_tokens += len(prefix)
        prompt_length = len(prompt)
    if decode_first_token:
        prompt, prefix = prompt[:-1], prompt[-1:] + prefix
        max_new_tokens += 1
        prompt_length = len(prompt)

    if next_tokens is not None:
        next_tokens = [int(t) for t in next_tokens]
        max_new_tokens = len(next_tokens)
        forced_first: Optional[int] = next_tokens[0]
        prefix = next_tokens[1:]
    elif prefix:
        forced_first, prefix = prefix[0], prefix[1:]
    else:
        forced_first = None

    # ---- prefill ---------------------------------------------------------
    P = _prefill_bucket(specs, prompt_length, prefill_bucket)
    if model.sp is not None:  # the query blocks split the bucket evenly
        P = -(-P // model.sp.sp) * model.sp.sp
    tokens = torch.tensor(
        [prompt + [pad_id] * (P - prompt_length)], dtype=torch.long, device=device
    )

    _sync(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        if model.pp is not None:
            from ..parallel.pp import pp_prefill

            logits = pp_prefill(model, caches, tokens, prompt_length, chunk=min(64, P))
        elif model.sp is not None:
            from ..parallel.sp import sp_prefill, sp_tp_prefill

            run = sp_prefill if model.tp is None else sp_tp_prefill
            logits = run(model, caches, tokens, prompt_length)
        else:
            logits = prefill(model, caches, tokens, prompt_length)
        prefill_probs = torch.softmax(logits.float(), dim=-1)
        greedy_tok = logits.argmax(dim=-1)
    prefill_probs_np = prefill_probs.cpu().numpy()  # waits for the device
    t1 = time.perf_counter()

    if forced_first is not None:
        first_token = torch.tensor([forced_first], dtype=torch.long, device=device)
        first_id = forced_first
    else:
        first_token = greedy_tok
        first_id = int(greedy_tok[0])
    first_prob = float(prefill_probs_np[0, first_id])

    # ---- decode loop -----------------------------------------------------
    max_steps = max(max_new_tokens - 1, 0)
    graph_info = None
    if max_steps > 0:
        tokens_buf, probs_buf, last_probs, steps, graph_info = decode_loop_core(
            model, caches, first_token, prompt_length, prefix, terminator_ids,
            max_steps, attn_top_k, cuda_graph,
        )
        tokens_np = tokens_buf.cpu().numpy()  # the one read of the loop
        t2 = time.perf_counter()
        gen = [int(t) for t in tokens_np[:, 0] if int(t) != -1]
        emitted_probs = [first_prob] + [
            float(p) for p in probs_buf[:steps, 0].cpu().numpy()
        ]
        final_probs = last_probs[0].cpu().numpy()
    else:
        t2 = t1
        gen = [first_id]
        steps = 0
        emitted_probs = [first_prob]
        final_probs = prefill_probs_np[0]

    seq = prompt + gen
    prefill_seconds = t1 - t0
    decode_seconds = max(t2 - t1, 1e-9)
    decode_tokens = steps + 1
    total_seconds = t2 - t0
    perf_stats = {
        "prefill_tokens": prompt_length,
        "decode_tokens": decode_tokens,
        "decode_steps": steps,
        "prefill_toks_per_sec": prompt_length / max(prefill_seconds, 1e-9),
        "decode_toks_per_sec": decode_tokens / decode_seconds,
        "total_toks_per_sec": decode_tokens / max(total_seconds, 1e-9),
        "total_seconds": total_seconds,
        "prefill_seconds": prefill_seconds,
        "decode_seconds": decode_seconds,
        "decode_seconds_frac_of_total": decode_seconds / max(total_seconds, 1e-9),
        "memory_used_gb": (
            torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else 0.0
        ),
    }
    info = {
        "perf_stats": perf_stats,
        "emitted_probs": emitted_probs,
        "final_probs": final_probs,
        "decode_graph": graph_info,
        "prompt_length": prompt_length,
        "num_generated": len(gen),
        "vocab_size": cfg.vocab_size,
    }
    return seq, info, caches


def generate_batch(
    model: Transformer,
    caches,
    prompts: Sequence[Sequence[int]],
    max_new_tokens: int,
    *,
    terminator_ids: Optional[Sequence[int]] = None,
    attn_top_k: float = 1.0,
    pad_id: int = 0,
    prefill_bucket: Optional[int] = None,
    cuda_graph: Optional[bool] = None,
) -> Tuple[List[List[int]], Dict[str, Any], Any]:
    """Batched greedy generation, the JAX package's ``generate_batch``: B
    prompts of different lengths share one prefill bucket and decode in
    lock-step, each lane from its own position, with its own terminator
    stop and its own cache state. The caches must have been built for
    ``len(prompts)`` lanes. A lane whose prompt fills the smallest cache
    feeds its last token through decode. A finished lane records nothing
    more. Decode runs through the captured graph on the card, as in
    ``generate()``.

    On a rank of a (dp, tp) layout (``model.tp``; see ``generate()``)
    with dp > 1, every rank is given all B prompts and runs
    the ``B / dp`` lanes of its replica (its caches built for that many),
    in the bucket of all B; the loop stops when every replica's lanes are
    done, and the lanes of every replica are gathered, so that each rank
    returns all B in lane order (with its own caches).

    Returns ``(sequences, info, caches)``: ``sequences[b]`` is lane b's
    prompt (less a token fed through decode) and its generation;
    ``info["perf_stats"]`` gives aggregate rates over the lanes, and
    ``info`` also holds ``emitted_probs`` and ``num_generated`` per lane,
    ``final_probs`` [B, vocab], ``prompt_lengths``, ``decode_steps`` (the
    steps run) and ``decode_graph``."""
    cuda_graph = _use_graph(model, cuda_graph)
    if model.sp is not None or model.pp is not None:
        from ..parallel.mesh import PP_ALONE, SP_LANES

        raise ValueError(SP_LANES if model.sp is not None else PP_ALONE)
    prompts = [[int(t) for t in p] for p in prompts]
    kw = dict(terminator_ids=terminator_ids, attn_top_k=attn_top_k, pad_id=pad_id,
              cuda_graph=cuda_graph)
    if model.tp is None or model.tp.dp == 1:
        return _batch_lanes(model, caches, prompts, max_new_tokens,
                            prefill_bucket=prefill_bucket, **kw)
    return _batch_over_dp(model, caches, prompts, max_new_tokens,
                          prefill_bucket=prefill_bucket, **kw)


def _prefill_lengths(specs, prompts) -> List[int]:
    """Each lane's prefill length: a prompt exactly as long as the shortest
    cache feeds its last token through decode instead."""
    mcl = engine.min_cache_length(specs)
    return [len(p) - (len(p) == mcl) for p in prompts]


def _batch_over_dp(model: Transformer, caches, prompts, max_new_tokens: int, *,
                   prefill_bucket, **kw):
    """``generate_batch`` on one dp replica's lanes, in the bucket of every
    replica's lanes, then every replica's lanes gathered in lane order."""
    tp_ctx = model.tp
    B, dp = len(prompts), tp_ctx.dp
    if B % dp:
        raise ValueError(f"dp shards batch lanes: {B} lanes do not divide over dp={dp}")
    Bl = B // dp
    if caches[0].k.shape[0] != Bl:
        raise ValueError(f"caches hold {caches[0].k.shape[0]} lanes; a dp={dp} replica of {B} "
                         f"lanes runs {Bl}")
    specs = [c.spec for c in caches]
    bucket = _prefill_bucket(specs, max(_prefill_lengths(specs, prompts)), prefill_bucket)
    lo = tp_ctx.d * Bl
    seqs, info, caches = _batch_lanes(model, caches, prompts[lo:lo + Bl], max_new_tokens,
                                      prefill_bucket=bucket, all_done=tp_ctx.all_done, **kw)
    lane_keys = ("emitted_probs", "prompt_lengths", "num_generated")
    parts = tp_ctx.gather_lanes((seqs, {k: info[k] for k in lane_keys}, info["final_probs"],
                                 info["perf_stats"]))
    seqs = [s for part in parts for s in part[0]]
    merged = {k: [v for part in parts for v in part[1][k]] for k in lane_keys}
    perfs = [part[3] for part in parts]
    tokens = {k: sum(p[k] for p in perfs) for k in ("prefill_tokens", "decode_tokens")}
    secs = {k: max(p[k] for p in perfs)
            for k in ("prefill_seconds", "decode_seconds", "total_seconds")}
    perf = {
        "batch_size": B, **tokens,
        "prefill_toks_per_sec": tokens["prefill_tokens"] / max(secs["prefill_seconds"], 1e-9),
        "decode_toks_per_sec": tokens["decode_tokens"] / secs["decode_seconds"],
        "total_toks_per_sec": tokens["decode_tokens"] / max(secs["total_seconds"], 1e-9),
        **secs,
        "decode_seconds_frac_of_total": secs["decode_seconds"] / max(secs["total_seconds"],
                                                                     1e-9),
        "memory_used_gb": max(p["memory_used_gb"] for p in perfs),
    }
    info = {**info, **merged, "perf_stats": perf,
            "final_probs": np.concatenate([part[2] for part in parts])}
    return seqs, info, caches


def _batch_lanes(model: Transformer, caches, prompts: List[List[int]], max_new_tokens: int, *,
                 terminator_ids, attn_top_k: float, pad_id: int, prefill_bucket: Optional[int],
                 cuda_graph: bool, all_done: Optional[Callable[[torch.Tensor], bool]] = None):
    """``generate_batch`` over the lanes this process holds."""
    device = model.device
    B = len(prompts)
    terminator_ids = [int(t) for t in (terminator_ids or [])]
    specs = [c.spec for c in caches]
    lens = _prefill_lengths(specs, prompts)
    forced_first = [p[-1] if n < len(p) else -1 for p, n in zip(prompts, lens)]

    P = _prefill_bucket(specs, max(lens), prefill_bucket)
    if P < max(lens):
        raise ValueError(f"Longest prompt ({max(lens)} tokens) exceeds the prefill bucket ({P}).")
    tokens = torch.tensor(
        [p[: lens[b]] + [pad_id] * (P - lens[b]) for b, p in enumerate(prompts)],
        dtype=torch.long, device=device,
    )
    plen = torch.tensor(lens, dtype=torch.int32, device=device)

    _sync(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = prefill(model, caches, tokens, plen)
        prefill_probs = torch.softmax(logits.float(), dim=-1)
        forced = torch.tensor(forced_first, dtype=torch.long, device=device)
        first_token = torch.where(forced >= 0, forced, logits.argmax(dim=-1))
    prefill_probs_np = prefill_probs.cpu().numpy()  # waits for the device
    t1 = time.perf_counter()
    first_np = first_token.cpu().numpy()
    first_probs = [float(prefill_probs_np[b, int(first_np[b])]) for b in range(B)]

    max_steps = max(max_new_tokens - 1, 0)
    graph_info = None
    if max_steps > 0:
        tokens_buf, probs_buf, last_probs, steps, graph_info = decode_loop_core(
            model, caches, first_token, lens, [], terminator_ids, max_steps, attn_top_k,
            cuda_graph, all_done,
        )
        tokens_np = tokens_buf.cpu().numpy()  # the one read of the loop
        t2 = time.perf_counter()
        gens = [[int(t) for t in tokens_np[:, b] if int(t) != -1] for b in range(B)]
        probs_np = probs_buf.cpu().numpy()
        emitted_probs = [
            [first_probs[b]] + [float(p) for p in probs_np[: len(gens[b]) - 1, b]]
            for b in range(B)
        ]
        final_probs = last_probs.cpu().numpy()
    else:
        t2 = t1
        steps = 0
        gens = [[int(first_np[b])] for b in range(B)]
        emitted_probs = [[first_probs[b]] for b in range(B)]
        final_probs = prefill_probs_np

    seqs = [prompts[b][: lens[b]] + gens[b] for b in range(B)]
    prefill_seconds = t1 - t0
    decode_seconds = max(t2 - t1, 1e-9)
    decode_tokens = sum(len(g) for g in gens)
    total_seconds = t2 - t0
    perf_stats = {
        "batch_size": B,
        "prefill_tokens": int(sum(lens)),
        "decode_tokens": decode_tokens,
        "prefill_toks_per_sec": sum(lens) / max(prefill_seconds, 1e-9),
        "decode_toks_per_sec": decode_tokens / decode_seconds,
        "total_toks_per_sec": decode_tokens / max(total_seconds, 1e-9),
        "total_seconds": total_seconds,
        "prefill_seconds": prefill_seconds,
        "decode_seconds": decode_seconds,
        "decode_seconds_frac_of_total": decode_seconds / max(total_seconds, 1e-9),
        "memory_used_gb": (
            torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else 0.0
        ),
    }
    info = {
        "perf_stats": perf_stats,
        "emitted_probs": emitted_probs,
        "final_probs": final_probs,
        "prompt_lengths": lens,
        "num_generated": [len(g) for g in gens],
        "decode_steps": steps,
        "decode_graph": graph_info,
    }
    return seqs, info, caches


def _decode_body(model: Transformer, caches, buf: LoopBuffers, attn_top_k: float) -> None:
    """One decode step, the JAX ``body``, writing every result in place into
    ``buf`` (nothing is rebound, so a captured step keeps its buffers):
    step ``buf.i`` feeds ``buf.cur`` at ``buf.pos``, emits the forced token
    or the greedy one, records it and its probability unless the lane is
    done, and advances."""
    logits = decode_step(model, caches, buf.cur, buf.pos, attn_top_k)
    probs = torch.softmax(logits.float(), dim=-1)
    forced = buf.forced.index_select(0, buf.i)  # [1]
    teacher = forced >= 0
    next_tok = torch.where(teacher, forced, logits.argmax(dim=-1))  # [B]
    p_emit = probs.gather(1, next_tok[:, None])[:, 0]
    is_term = (next_tok[:, None] == buf.term[None, :]).any(dim=-1) & ~teacher
    done = buf.done
    buf.tokens.index_copy_(0, buf.i + 1, torch.where(done, -1, next_tok)[None])
    buf.probs.index_copy_(0, buf.i, torch.where(done, 0.0, p_emit)[None])
    buf.last_probs.copy_(torch.where(done[:, None], buf.last_probs, probs))
    done |= is_term
    buf.cur.copy_(next_tok)
    buf.pos += 1
    buf.i += 1


def decode_loop_core(model: Transformer, caches, first_token: torch.Tensor,
                     start_pos: Union[int, Sequence[int]], prefix: Sequence[int],
                     terminator_ids: Sequence[int], max_steps: int, attn_top_k: float = 1.0,
                     cuda_graph: bool = False,
                     all_done: Optional[Callable[[torch.Tensor], bool]] = None):
    """Greedy decode with everything kept on the device, each lane from its
    own position (``start_pos``: an int for every lane, or one per lane).

    Returns (tokens [max_steps + 1, B] with slot 0 the first token and -1
    after a lane finished, emitted probabilities [max_steps, B], the last
    distribution [B, vocab] of each lane while it was running, the number
    of steps run, the graph's record or None). ``prefix`` forces the first
    steps' tokens. With terminators, the loop ends after the first step
    that is not teacher-forced and leaves every lane done: ``all_done``
    (``done`` [B] -> bool, read on the host) decides that when lanes live
    on other ranks too (``TpContext.all_done``), else ``done.all()``.

    With ``cuda_graph`` every step replays the model's captured step. Where
    the model holds none for these caches yet, step 0 runs eagerly first
    (it warms every first-call path) and the step is captured before step
    1. The returned tensors are then views of the graph's buffers, valid
    until the next call."""
    device = first_token.device
    B = first_token.shape[0]
    forced = list(prefix[:max_steps]) + [-1] * max(0, max_steps - len(prefix))
    terminators = list(terminator_ids)
    start_pos = [int(start_pos)] * B if isinstance(start_pos, int) else [int(p) for p in start_pos]
    if len(start_pos) != B:
        raise ValueError(f"{len(start_pos)} start positions for {B} lanes")
    last_pos = max(start_pos) + max_steps - 1
    if last_pos >= model.rope.shape[0]:
        raise ValueError(f"decode positions up to {last_pos} exceed the "
                         f"model's {model.rope.shape[0]} rope rows")
    n_term = max(1, len(terminators))
    if cuda_graph:
        graph = decode_graph(model, caches, B, attn_top_k, n_term,
                             lambda b: _decode_body(model, caches, b, attn_top_k))
        buf, stream, eager_first = graph.buffers, graph.on_stream(), not graph.captured
    else:
        graph, stream, eager_first = None, contextlib.nullcontext(), True
        buf = LoopBuffers.empty(B, model.cfg.vocab_size, max_steps, n_term, device)
    steps = 0
    with stream, torch.inference_mode():
        buf.load(first_token, start_pos, forced, terminators)
        for i in range(max_steps):
            if graph is None or (i == 0 and eager_first):
                _decode_body(model, caches, buf, attn_top_k)
            else:
                graph.replay()
            steps = i + 1
            if terminators and forced[i] < 0 and (
                    bool(buf.done.all()) if all_done is None else all_done(buf.done)):
                break
    info = None if graph is None else {
        "captured": eager_first and graph.captured, "capture_seconds": graph.capture_seconds,
        "pool_bytes": graph.pool_bytes, "launches_per_replay": dict(graph.launches)}
    return buf.tokens[: max_steps + 1], buf.probs[:max_steps], buf.last_probs, steps, info


def reset_caches(caches):
    """Fresh cache states for a new example, zeroed in place."""
    for c in caches:
        reset_state(c)
    return caches
