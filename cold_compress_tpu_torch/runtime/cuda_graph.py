"""One decode step captured as a CUDA graph and replayed once per token.

The JAX package runs its decode loop as one jitted ``lax.while_loop``
(``decode_loop_core``): no host code runs per token. Here the step body of
``runtime/generate.py::decode_loop_core`` is captured once with
``torch.cuda.graph`` and replayed once per step. The call that captures
it runs step 0 eagerly first, so that first-call host work (building the
kernels, ``cudaFuncSetAttribute``, the occupancy and cluster queries,
hybrid's menu tables) never runs under capture, and replays from step 1
on; a later call replays every step. A capture or replay that fails
raises; nothing carries on eagerly.

Every tensor the step reads or writes lives at a fixed address: the model's
weights, the caches (updated in place) and the loop's ``LoopBuffers``, which
the graph owns. The graph is kept on the model and replayed by a later
``generate()`` whose caches, weights, batch, ``attn_top_k``, decode
attention's ``i8dot`` mode and terminator count match (``graph_key``): a second call after ``reset_caches`` replays
without capturing.

A tensor-parallel shard's step holds its tp group's collectives (two
all-reduces per layer, the logits' all-gather). NCCL's are captured with
the step: one eager collective on each of the rank's groups runs first, so
that no communicator is created under capture, and the capture is
thread-local (NCCL's watchdog thread keeps polling its events meanwhile).
gloo's cannot be captured (``runtime/generate.py`` decodes eagerly there).

Launch counters (``ops.kernel_launches``) are Python increments that a
replay does not run. The capture records how many launches of each kernel
the step made (and takes them back: a capture runs nothing), and each
replay adds them again.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from .. import ops
from . import trace


@dataclass
class LoopBuffers:
    """The decode loop's state on the device, written in place by every
    step (``decode_loop_core``'s carry). ``forced``, ``tokens`` and
    ``probs`` have room for ``cap`` steps; a step reads and writes them at
    the device counter ``i``."""

    i: torch.Tensor  # [1] int64, the step counter
    pos: torch.Tensor  # [B] int32, the position of ``cur``
    cur: torch.Tensor  # [B] int64, the token the next step feeds
    done: torch.Tensor  # [B] bool, lanes past a terminator
    forced: torch.Tensor  # [cap] int64, the teacher-forced token, -1 where greedy
    term: torch.Tensor  # [T] int64, terminator ids padded with -1
    tokens: torch.Tensor  # [cap + 1, B] int64, slot 0 the first token, -1 after done
    probs: torch.Tensor  # [cap, B] f32, each emitted token's probability
    last_probs: torch.Tensor  # [B, vocab] f32, each lane's last distribution

    @classmethod
    def empty(cls, B: int, vocab: int, cap: int, n_term: int, device) -> "LoopBuffers":
        kw = dict(device=device)
        return cls(
            i=torch.zeros((1,), dtype=torch.long, **kw),
            pos=torch.zeros((B,), dtype=torch.int32, **kw),
            cur=torch.zeros((B,), dtype=torch.long, **kw),
            done=torch.zeros((B,), dtype=torch.bool, **kw),
            forced=torch.full((cap,), -1, dtype=torch.long, **kw),
            term=torch.full((n_term,), -1, dtype=torch.long, **kw),
            tokens=torch.full((cap + 1, B), -1, dtype=torch.long, **kw),
            probs=torch.zeros((cap, B), dtype=torch.float32, **kw),
            last_probs=torch.zeros((B, vocab), dtype=torch.float32, **kw),
        )

    def load(self, first_token: torch.Tensor, start_pos, forced, terminators) -> None:
        """Set up a new loop, in place: each lane's first token at its
        position in ``start_pos`` (one per lane), the forced tokens (-1 where
        greedy) and the terminators."""
        if len(forced) > self.forced.shape[0] or len(terminators) > self.term.shape[0]:
            raise ValueError("decode loop buffers too small for this call")
        self.i.zero_()
        self.pos.copy_(torch.tensor(start_pos, dtype=torch.int32))
        self.cur.copy_(first_token)
        self.done.zero_()
        self.forced.fill_(-1)
        if len(forced):
            self.forced[: len(forced)].copy_(torch.tensor(forced, dtype=torch.long))
        self.term.fill_(-1)
        if len(terminators):
            self.term[: len(terminators)].copy_(torch.tensor(terminators, dtype=torch.long))
        self.tokens.fill_(-1)
        self.tokens[0].copy_(first_token)
        self.probs.zero_()
        self.last_probs.zero_()


def graph_key(model, caches, B: int, attn_top_k: float, n_term: int) -> tuple:
    """What a captured step depends on: the model's config and the address,
    type and shape of every weight, the cache specs and the address, type
    and shape of every cache tensor, the batch, ``attn_top_k``, the
    terminator count, decode attention's ``i8dot`` mode (a Python
    attribute, which no tensor holds) and the tensor-parallel context."""

    def where(t: torch.Tensor):
        return t.data_ptr(), t.dtype, tuple(t.shape)

    weights = tuple((type(m).__name__, tuple(where(b) for b in m.buffers(recurse=False)))
                    for m in model.modules())
    cache_part = tuple((c.spec, tuple(where(t) for t in c.tensors())) for c in caches)
    tp = None if model.tp is None else model.tp.key()
    return (model.cfg, weights, cache_part, B, float(attn_top_k), n_term, model.attn_i8dot, tp)


@dataclass
class DecodeGraph:
    """A decode step captured on ``stream`` (at the first ``replay``),
    with the buffers it reads and writes and what its capture recorded."""

    key: tuple
    buffers: LoopBuffers
    body: Callable[[LoopBuffers], None]  # one step over ``buffers``
    stream: torch.cuda.Stream
    tp: Optional[object] = None  # the model's TpContext where the step holds its collectives
    graph: Optional[torch.cuda.CUDAGraph] = None
    launches: Dict[str, int] = field(default_factory=dict)  # kernel launches per replay
    capture_seconds: float = 0.0
    pool_bytes: int = 0  # device memory the capture reserved (its private pool)

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def capture(self) -> None:
        """Capture ``body`` on the graph's stream. The step must have run
        eagerly before (first-call host work must not run under capture)."""
        dev = self.buffers.i.device
        torch.cuda.synchronize(dev)
        gc.collect()  # as torch.cuda.graph does first, so that the pool's bytes stand alone
        torch.cuda.empty_cache()
        mode = "global"
        if self.tp is not None:
            with torch.cuda.stream(self.stream):
                self.tp.warm()
            torch.cuda.synchronize(dev)
            mode = "thread_local"
        elif torch.distributed.is_available() and torch.distributed.is_initialized():
            # A rank whose step holds no collective (under sp or pp) still
            # has its process group's watchdog thread querying events: only
            # this thread's calls are held to the capture's rules.
            mode = "thread_local"
        before = ops.kernel_launches()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        with trace.span("decode.capture") as sp:
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode=mode):
                self.body(self.buffers)
            torch.cuda.synchronize(dev)
            self.capture_seconds = time.perf_counter() - t0
            sp.set(seconds=self.capture_seconds)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = ops.kernel_launches()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        ops.add_kernel_launches({k: -n for k, n in self.launches.items()})
        self.graph = graph

    def replay(self) -> None:
        """One decode step: capture first if needed, then replay on the
        current stream and count the step's kernel launches."""
        if self.graph is None:
            self.capture()
        with trace.span("decode.launch"):
            self.graph.replay()
        ops.add_kernel_launches(self.launches)

    @contextlib.contextmanager
    def on_stream(self):
        """Run the loop on the graph's stream (its eager steps too, so that
        they warm what the capture uses), ordered after and before the
        caller's stream."""
        caller = torch.cuda.current_stream(self.buffers.i.device)
        self.stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            caller.wait_stream(self.stream)


def decode_graph(model, caches, B: int, attn_top_k: float, n_term: int,
                 body: Callable[[LoopBuffers], None]) -> DecodeGraph:
    """The model's decode graph for these caches, or a new one (not yet
    captured) of the step ``body`` that replaces it."""
    key = graph_key(model, caches, B, attn_top_k, n_term)
    old: Optional[DecodeGraph] = getattr(model, "_decode_graph", None)
    if old is not None and old.key == key:
        return old
    model._decode_graph = None
    del old  # its memory pool goes before the new capture
    dev = model.device
    buffers = LoopBuffers.empty(B, model.cfg.vocab_size, model.rope.shape[0], n_term, dev)
    tp = model.tp if model.tp is not None and model.tp.tp > 1 else None
    graph = DecodeGraph(key, buffers, body, torch.cuda.Stream(dev), tp=tp)
    model._decode_graph = graph
    return graph


def model_decode_graph(model) -> Optional[DecodeGraph]:
    """The decode graph the model holds (the last one ``generate()`` used
    with ``cuda_graph``), or None."""
    return getattr(model, "_decode_graph", None)
