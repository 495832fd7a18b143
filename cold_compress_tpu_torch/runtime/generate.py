"""Generation runtime: prefill, then a greedy decode loop on the device.

Counterpart of ``cold_compress_tpu/runtime/generate.py`` (single-prompt
``generate``, ``decode_loop_core`` and ``reset_caches``). The JAX package
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
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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

    ``info`` holds ``perf_stats`` (seconds and tokens per second, timed
    with the device synchronised; a call that captures the graph counts
    the capture in its decode time), ``emitted_probs`` (the probability of
    each emitted or forced token), ``final_probs`` (the last step's
    distribution over the vocabulary) and ``decode_graph`` (None when
    eager; else whether this call captured, the capture's seconds, the
    graph pool's bytes and the kernel launches of one replay).
    """
    device = model.device
    if cuda_graph is None:
        cuda_graph = device.type == "cuda"
    if cuda_graph and device.type != "cuda":
        raise ValueError("cuda_graph needs the model on a CUDA device")
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
    # Direct-fill caches (full, hybrid, and the full outer cache of debug_*)
    # write all P padded slots, so the bucket must not exceed their length.
    direct_fill = [
        s.max_cache_length for s in specs
        if s.cache_strategy in ("full", "hybrid") or s.cache_strategy.startswith("debug_")
    ]
    P = prefill_bucket or bucket_length(prompt_length)
    if direct_fill and P > min(direct_fill):
        P = min(direct_fill)
        if P < prompt_length:
            raise ValueError(
                f"Prompt ({prompt_length} tokens) exceeds the smallest "
                f"direct-fill cache length ({P})."
            )
    tokens = torch.tensor(
        [prompt + [pad_id] * (P - prompt_length)], dtype=torch.long, device=device
    )

    _sync(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
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


def decode_loop_core(model: Transformer, caches, first_token: torch.Tensor, start_pos: int,
                     prefix: Sequence[int], terminator_ids: Sequence[int], max_steps: int,
                     attn_top_k: float = 1.0, cuda_graph: bool = False):
    """Greedy decode with everything kept on the device.

    Returns (tokens [max_steps + 1, B] with slot 0 the first token and -1
    after a lane finished, emitted probabilities [max_steps, B], the last
    distribution [B, vocab] of each lane while it was running, the number
    of steps run, the graph's record or None). ``prefix`` forces the first
    steps' tokens. With terminators, the loop ends after the first step
    that is not teacher-forced and leaves every lane done.

    With ``cuda_graph`` every step replays the model's captured step. Where
    the model holds none for these caches yet, step 0 runs eagerly first
    (it warms every first-call path) and the step is captured before step
    1. The returned tensors are then views of the graph's buffers, valid
    until the next call."""
    device = first_token.device
    B = first_token.shape[0]
    forced = list(prefix[:max_steps]) + [-1] * max(0, max_steps - len(prefix))
    terminators = list(terminator_ids)
    if start_pos + max_steps > model.rope.shape[0]:
        raise ValueError(f"decode positions up to {start_pos + max_steps - 1} exceed the "
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
            if terminators and forced[i] < 0 and bool(buf.done.all()):
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
