"""The (dp, tp) rank layout and its collectives.

Counterpart of ``cold_compress_tpu/parallel/mesh.py`` (``make_mesh``,
``validate_tp``) and ``parallel/tp_decode.py::make_tp_mesh``. The JAX
package has one controller over a ``(dp, tp)`` device mesh; here each rank
is a process (``parallel/launch.py`` starts them), ``world = dp * tp``
ranks with tp innermost: rank ``r = d * tp + t``. A rank's ``TpContext``
holds its two groups:

* the tp group (the ranks ``d * tp .. d * tp + tp - 1``) carries the two
  all-reduces per layer and the all-gather of the vocab-sharded logits, the
  JAX package's ``psum`` and ``all_gather(tiled=True)`` over ``"tp"``;
* the dp group (the ranks ``t, t + tp, ...``) carries the decode loop's
  stop decision, which must see every lane's done flag, and the end-of-run
  gather of the lanes.

``cache_pspecs``' rule (KV heads on tp, lanes on dp) is a fact of
construction here: a rank builds its caches with its local KV heads
(``tp_decode.py::local_cfg``) and its ``B / dp`` lanes.
"""

from __future__ import annotations

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
        """One eager collective on each group, so that their communicators
        exist before a CUDA graph captures the tp group's collectives."""
        for group in (self.tp_group, self.dp_group):
            x = torch.zeros((1,), device=self.device)
            dist.all_reduce(x, group=group)


def make_tp_context(tp: int, dp: int, device) -> Optional[TpContext]:
    """This rank's ``TpContext`` of a ``(dp, tp)`` layout over the first
    ``dp * tp`` ranks of the initialised world (``make_tp_mesh(tp, dp)``).
    Every rank of the world must call it, with the same arguments, since
    each group is created by all of them; a rank past ``dp * tp`` gets
    None."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * tp > world:
        raise ValueError(f"Need {dp * tp} ranks, have {world}")
    tp_groups = [dist.new_group(tp_ranks(tp, d)) for d in range(dp)]
    dp_groups = [dist.new_group(dp_ranks(tp, dp, t)) for t in range(tp)]
    if rank >= dp * tp:
        return None
    return TpContext(tp=tp, dp=dp, rank=rank, backend=dist.get_backend(),
                     device=torch.device(device), tp_group=tp_groups[rank // tp],
                     dp_group=dp_groups[rank % tp])

