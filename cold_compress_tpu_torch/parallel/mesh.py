"""The rank layouts and their collectives.

Counterpart of ``cold_compress_tpu/parallel/mesh.py`` (``make_mesh``, its
multi-process layout, ``validate_tp``), ``parallel/tp_decode.py::
make_tp_mesh``, ``parallel/sp.py::make_sp_mesh``/``make_sp_tp_mesh`` (both
``make_sp_tp_mesh`` here) and ``parallel/pp.py::make_pp_mesh``. The JAX
package has one controller over a
device mesh; here each rank is a process (``parallel/launch.py`` starts
them), and a ``Layout`` names the degrees: ``(dp, tp)`` (``TpContext``),
``(sp, tp)`` (``SpContext``) or ``pp`` stages (``PpContext``).

``(dp, tp)``: ``world = dp * tp`` ranks with tp innermost: rank
``r = d * tp + t``. A rank's ``TpContext`` holds its two groups:

* the tp group (the ranks ``d * tp .. d * tp + tp - 1``) carries the two
  all-reduces per layer and the all-gather of the vocab-sharded logits, the
  JAX package's ``psum`` and ``all_gather(tiled=True)`` over ``"tp"``;
* the dp group (the ranks ``t, t + tp, ...``) carries the decode loop's
  stop decision, which must see every lane's done flag, and the end-of-run
  gather of the lanes.

``cache_pspecs``' rule (KV heads on tp, lanes on dp) is a fact of
construction here: a rank builds its caches with its local KV heads
(``tp_decode.py::local_cfg``) and its ``B / dp`` lanes.

Across nodes (``torchrun`` with ``LOCAL_WORLD_SIZE`` below ``WORLD_SIZE``)
tp must fit within one node, so that its per-layer all-reduces stay on
NVLink, and dp spans the nodes: ``torchrun`` numbers ranks node-major, so
``r = d * tp + t`` keeps every tp group on one node (``check_node_layout``).

``(sp, tp)``: ``world = sp * tp`` ranks, tp innermost, rank
``r = s * tp + t``; an sp group per ``t`` (ranks ``t, t + tp, ...``)
gathers K/V and sums the attention summaries of the prefill's query
blocks, and a tp group per ``s`` is that sequence replica's ``TpContext``.
``pp``: stages in rank order, one group over them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch
import torch.distributed as dist

#: How long a collective (and the rendezvous) may wait for the other ranks
#: before it raises: a mismatched collective fails instead of hanging.
DEFAULT_TIMEOUT_S = 180


def validate_tp(cfg, tp: int) -> None:
    """Raise unless ``tp`` divides the KV heads, the query heads and the
    FFN width (the JAX package's messages)."""
    if cfg.n_kv_head % tp:
        raise ValueError(
            f"TP degree {tp} must divide n_kv_head={cfg.n_kv_head} so KV caches "
            "shard evenly on the head axis.")
    if cfg.n_head % tp or cfg.intermediate_size % tp:
        raise ValueError(
            f"tp={tp} must divide n_head={cfg.n_head} / intermediate_size="
            f"{cfg.intermediate_size}")


def tp_ranks(tp: int, d: int) -> List[int]:
    """The world ranks of data-parallel replica ``d``'s tp group."""
    return [d * tp + t for t in range(tp)]


def dp_ranks(tp: int, dp: int, t: int) -> List[int]:
    """The world ranks holding shard ``t`` in every replica (a dp group)."""
    return [d * tp + t for d in range(dp)]


@dataclass
class TpContext:
    """One rank's place in a ``(dp, tp)`` layout, its two process groups,
    the backend (``nccl`` or ``gloo``) and the device it computes on. The
    rank's model holds it as ``model.tp`` (``tp_decode.py::build_tp_model``),
    where ``generate`` and ``generate_batch`` read it: the JAX package's
    ``tp_ctx`` argument. At tp = 1 (dp alone) it runs no collective in the
    model."""

    tp: int
    dp: int
    rank: int  # r = d * tp + t
    backend: str
    device: torch.device
    tp_group: Any = field(repr=False, default=None)
    dp_group: Any = field(repr=False, default=None)

    @property
    def t(self) -> int:
        """This rank's shard index in its tp group."""
        return self.rank % self.tp

    @property
    def d(self) -> int:
        """This rank's data-parallel replica (its block of lanes)."""
        return self.rank // self.tp

    @property
    def capturable(self) -> bool:
        """Whether a decode step's collectives can be captured in a CUDA
        graph: at tp = 1 it has none; NCCL's can be, gloo's run on the host."""
        return self.tp == 1 or self.backend == "nccl"

    def key(self) -> tuple:
        """What a captured decode step depends on besides its tensors."""
        return (self.tp, self.dp, self.rank, self.backend)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the tp group, in place, in x's dtype (the JAX
        package's ``psum``)."""
        if self.tp > 1:
            dist.all_reduce(x, group=self.tp_group)
        return x

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate every tp shard's ``x`` on the last axis in shard order
        (``all_gather(tiled=True)``: contiguous vocab blocks). NCCL gathers
        into one tensor. gloo gathers no CUDA tensor, so there each shard
        writes its block into zeros and the blocks are summed: every element
        has one nonzero term, so the sum is exact."""
        if self.tp == 1:
            return x
        x = x.contiguous()
        if self.backend == "nccl":
            out = x.new_empty((self.tp, *x.shape))
            dist.all_gather_into_tensor(out, x, group=self.tp_group)
            return out.movedim(0, -2).reshape(*x.shape[:-1], self.tp * x.shape[-1])
        full = x.new_zeros((*x.shape[:-1], self.tp, x.shape[-1]))
        full[..., self.t, :] = x
        dist.all_reduce(full, group=self.tp_group)
        return full.reshape(*x.shape[:-1], self.tp * x.shape[-1])

    def all_done(self, done: torch.Tensor) -> bool:
        """Whether every lane of every replica is done (one read on the host):
        dp replicas hold different lanes, and all must stop at the same step
        or the next all-reduce of the one that went on would wait forever."""
        flag = done.all().to(torch.int32).reshape(1)
        if self.dp > 1:
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.dp_group)
        return bool(flag)

    def gather_lanes(self, obj) -> list:
        """Every replica's ``obj`` (a picklable result of its lanes), in
        replica order."""
        if self.dp == 1:
            return [obj]
        out = [None] * self.dp
        dist.all_gather_object(out, obj, group=self.dp_group)
        return out

    def warm(self) -> None:
        """One eager collective on each group of more than one rank, so that
        their communicators exist before a CUDA graph captures the tp
        group's collectives."""
        for group, n in ((self.tp_group, self.tp), (self.dp_group, self.dp)):
            if n > 1:
                x = torch.zeros((1,), device=self.device)
                dist.all_reduce(x, group=group)


def local_world_size(world: int) -> int:
    """Ranks per node: ``torchrun``'s ``LOCAL_WORLD_SIZE``, else the whole
    world (one node)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def check_node_layout(tp: int, dp: int, local: int) -> None:
    """The multi-node layout of the JAX package's ``make_mesh``: with
    ``local`` ranks per node, tp must fit within (and divide) one node's
    ranks, so that every tp group is node-local; dp spans the nodes."""
    world = tp * dp
    if local >= world:
        return
    if tp > local or local % tp:
        raise ValueError(
            f"tp={tp} must fit within one node's {local} ranks so its all-reduces ride "
            "NVLink; shard dp across nodes instead.")
    for d in range(dp):  # node-major rank numbering: r // local is r's node
        nodes = {r // local for r in tp_ranks(tp, d)}
        assert len(nodes) == 1, f"tp group {tp_ranks(tp, d)} spans nodes {sorted(nodes)}"


def make_tp_context(tp: int, dp: int, device) -> Optional[TpContext]:
    """This rank's ``TpContext`` of a ``(dp, tp)`` layout over the first
    ``dp * tp`` ranks of the initialised world (``make_tp_mesh(tp, dp)``;
    ``make_mesh``'s multi-node layout: ``check_node_layout``). Every rank
    of the world must call it, with the same arguments, since each group is
    created by all of them; a rank past ``dp * tp`` gets None."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * tp > world:
        raise ValueError(f"Need {dp * tp} ranks, have {world}")
    check_node_layout(tp, dp, local_world_size(world))
    tp_groups = [dist.new_group(tp_ranks(tp, d)) for d in range(dp)]
    dp_groups = [dist.new_group(dp_ranks(tp, dp, t)) for t in range(tp)]
    if rank >= dp * tp:
        return None
    return TpContext(tp=tp, dp=dp, rank=rank, backend=dist.get_backend(),
                     device=torch.device(device), tp_group=tp_groups[rank // tp],
                     dp_group=dp_groups[rank % tp])


# --------------------------------------------------------------------------
# Sequence parallelism (and sp x tp)
# --------------------------------------------------------------------------


@dataclass
class SpContext:
    """One rank's place in an ``(sp, tp)`` layout: its sequence shard
    ``s`` (query rows ``[s P / sp, (s + 1) P / sp)`` of the prefill), its sp
    group (the ranks holding the same tp shard) and, at tp > 1, the
    ``TpContext`` of its replica's tp group. The rank's model holds it as
    ``model.sp`` (``tp_decode.py::build_rank_model``)."""

    sp: int
    tp: int
    rank: int  # r = s * tp + t
    backend: str
    device: torch.device
    sp_group: Any = field(repr=False, default=None)
    tp_ctx: Optional[TpContext] = None

    @property
    def s(self) -> int:
        """This rank's sequence shard."""
        return self.rank // self.tp

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the sp group, in place (the JAX ``psum`` over
        ``"sp"``)."""
        dist.all_reduce(x, group=self.sp_group)
        return x

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` [B, KVH, Pl, D] concatenated on the sequence
        axis in shard order, [B, KVH, sp * Pl, D] (``all_gather(axis=2,
        tiled=True)``). NCCL gathers into one tensor; gloo gathers no CUDA
        tensor, so there each shard writes its block into zeros and the
        blocks are summed, every element from one nonzero term (exact)."""
        x = x.contiguous()
        B, KVH, Pl, D = x.shape
        if self.backend == "nccl":
            out = x.new_empty((self.sp, *x.shape))
            dist.all_gather_into_tensor(out, x, group=self.sp_group)
            return out.permute(1, 2, 0, 3, 4).reshape(B, KVH, self.sp * Pl, D)
        full = x.new_zeros((B, KVH, self.sp, Pl, D))
        full[:, :, self.s] = x
        dist.all_reduce(full, group=self.sp_group)
        return full.reshape(B, KVH, self.sp * Pl, D)


def make_sp_tp_mesh(sp: int, tp: int, device) -> Optional[SpContext]:
    """This rank's ``SpContext`` of an ``(sp, tp)`` layout over the first
    ``sp * tp`` ranks (tp innermost: tp's per-layer all-reduces are the
    latency-critical collective); at tp = 1 one sp group, the JAX package's
    ``make_sp_mesh``. Every rank of the world calls it; a rank past
    ``sp * tp`` gets None."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if sp * tp > world:
        raise ValueError(f"Need {sp * tp} ranks, have {world}")
    check_node_layout(tp, sp, local_world_size(world))
    tp_groups = [dist.new_group(tp_ranks(tp, s)) for s in range(sp)]
    sp_groups = [dist.new_group(dp_ranks(tp, sp, t)) for t in range(tp)]
    if rank >= sp * tp:
        return None
    backend, device = dist.get_backend(), torch.device(device)
    tp_ctx = None
    if tp > 1:
        tp_ctx = TpContext(tp=tp, dp=1, rank=rank, backend=backend, device=device,
                           tp_group=tp_groups[rank // tp])
    return SpContext(sp=sp, tp=tp, rank=rank, backend=backend, device=device,
                     sp_group=sp_groups[rank % tp], tp_ctx=tp_ctx)


# --------------------------------------------------------------------------
# Pipeline parallelism
# --------------------------------------------------------------------------


@dataclass
class PpContext:
    """One stage of a ``pp``-stage pipeline (stage = rank), its group and
    the sends it has not waited for. The rank's model holds it as
    ``model.pp``. NCCL sends and receives on the card; gloo has no CUDA
    send, so there an activation hops through the host."""

    pp: int
    rank: int
    backend: str
    device: torch.device
    group: Any = field(repr=False, default=None)
    _sends: list = field(default_factory=list, repr=False)

    def _via_host(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type == "cuda"

    def send_next(self, x: torch.Tensor) -> None:
        """Send ``x`` to the next stage without waiting (``flush`` waits)."""
        x = x.contiguous()
        if self._via_host(x):
            x = x.cpu()
        self._sends.append((dist.isend(x, self.rank + 1, group=self.group), x))

    def recv_prev(self, like: torch.Tensor) -> torch.Tensor:
        """The previous stage's next tensor of ``like``'s shape and dtype."""
        buf = torch.empty_like(like, device="cpu" if self._via_host(like) else like.device)
        dist.recv(buf, self.rank - 1, group=self.group)
        return buf.to(like.device)

    def flush(self) -> None:
        for work, _ in self._sends:
            work.wait()
        self._sends.clear()

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """``x`` from stage ``src`` on every stage, in place."""
        dist.broadcast(x, src, group=self.group)
        return x


def make_pp_mesh(pp: int, device) -> Optional[PpContext]:
    """Stages over the first ``pp`` ranks, in rank order. Every rank of the
    world calls it; a rank past ``pp`` gets None."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if pp > world:
        raise ValueError(f"Need {pp} ranks, have {world}")
    group = dist.new_group(list(range(pp)))
    if rank >= pp:
        return None
    return PpContext(pp=pp, rank=rank, backend=dist.get_backend(),
                     device=torch.device(device), group=group)


# --------------------------------------------------------------------------
# Layouts
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Layout:
    """The degrees of a run: ``(dp, tp)``, ``(sp, tp)`` or ``pp`` alone
    (the JAX CLIs' combinations)."""

    tp: int = 1
    dp: int = 1
    sp: int = 1
    pp: int = 1

    def __post_init__(self):
        for name in ("tp", "dp", "sp", "pp"):
            if getattr(self, name) < 1:
                raise ValueError(f"--{name} {getattr(self, name)}: a degree is at least 1")
        if self.pp > 1 and self.tp * self.dp * self.sp > 1:
            raise ValueError(PP_ALONE)
        if self.sp > 1 and self.dp > 1:
            raise ValueError(SP_LANES)

    @property
    def world(self) -> int:
        return self.tp * self.dp * self.sp * self.pp


#: The JAX CLIs' refusals (bare assertions there) for combinations the
#: layouts do not take.
PP_ALONE = "--pp runs alone: no --tp, --sp, --dp or batched lanes with it"
SP_LANES = ("--sp composes with --tp (2-D sp x tp) on single-lane runs; dp/batched lanes "
            "take --tp/--dp alone")


def make_context(layout: Layout, device):
    """This rank's context of ``layout`` (every rank of the world calls
    it): a ``PpContext``, an ``SpContext`` or a ``TpContext``; None for a
    rank past the layout's world."""
    if layout.pp > 1:
        return make_pp_mesh(layout.pp, device)
    if layout.sp > 1:
        return make_sp_tp_mesh(layout.sp, layout.tp, device)
    return make_tp_context(layout.tp, layout.dp, device)

