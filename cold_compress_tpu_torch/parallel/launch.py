"""Start the ranks of a parallel run and collect what each returns.

The JAX package has one controller that owns every device; the port runs
one process per rank. ``launch(fn, *args, tp=, dp=, sp=, pp=, device=)``
starts the layout's ranks (``mesh.Layout``: ``dp * tp``, ``sp * tp`` or
``pp``) with ``torch.multiprocessing`` (spawn), or, when the process
already runs under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` set), joins that world in place, so that

    torchrun --nproc_per_node 2 -m cold_compress_tpu_torch.generate --tp 2 --tp_kernels ...

and ``python -m cold_compress_tpu_torch.generate --tp 2 --tp_kernels ...``
run the same ranks. Each rank calls ``fn(ctx, *args)`` with its context
(``mesh.TpContext``, ``SpContext`` or ``PpContext``); ``fn`` and ``args``
must pickle (a function of a module, by its import path). Across nodes
(``LOCAL_WORLD_SIZE`` below the world, as ``torchrun`` sets it; spawned
ranks inherit it from the parent's environment) tp stays within a node:
each rank's context raises otherwise (``mesh.check_node_layout``).

* Backend: ``gloo`` on the CPU; on cards ``nccl``, one card per rank (the
  run raises when fewer cards are visible). ``backend="gloo"`` with
  ``device="cuda"`` must be asked for by name: the ranks then share the
  visible cards (all of them card 0 on a one-card machine), compute there
  and exchange through gloo on the host. Nothing switches backend after a
  failure.
* The rendezvous is a ``FileStore`` in a temporary directory: no port, so
  concurrent runs cannot collide. Every process group waits at most
  ``timeout`` seconds in a collective before it raises.
* The parent joins every rank; a rank that raises or dies makes the others
  stop and the parent raise, and so do ranks that have written their
  result but do not exit within ``TEARDOWN_S`` (a hung teardown). Only
  rank 0's standard output is kept.
* Spawned CPU ranks run torch at one thread. On cards the parent builds
  the kernels first (``ops/_build.py``), so the ranks only load them.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import os
import time
import pickle
import shutil
import tempfile
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT_S, Layout, make_context

_CALL, _RESULT = "call.pkl", "rank{}.pkl"
#: Seconds the parent waits for ranks that have written their result to
#: exit before it stops them and raises.
TEARDOWN_S = 60


def under_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def choose_backend(device: torch.device, world: int, backend: Optional[str]) -> str:
    """The backend of a ``world``-rank run on ``device``: gloo on the CPU,
    NCCL on cards (one per rank), or ``backend`` when given by name."""
    if backend is not None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {backend!r} (nccl or gloo)")
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("nccl needs device='cuda'")
        return backend
    if device.type != "cuda":
        return "gloo"
    n = torch.cuda.device_count()
    if n < world:
        raise RuntimeError(
            f"{world} ranks over NCCL need {world} cards, {n} visible; pass "
            "backend='gloo' to let the ranks share the cards (no CUDA graphs)")
    return "nccl"


def rank_device(device: torch.device, backend: str, rank: int, local_rank: int) -> torch.device:
    if device.type != "cuda":
        return device
    if backend == "nccl":
        return torch.device("cuda", local_rank)
    return torch.device("cuda", rank % torch.cuda.device_count())


def _run_rank(rank: int, world: int, layout: Layout, backend: str, device: torch.device,
              local_rank: int, store, timeout_s: float, fn: Callable, args: tuple):
    """Initialise this rank's process group, run ``fn`` on its context and
    tear the group down."""
    dev = rank_device(device, backend, rank, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"store": store} if store is not None else {"init_method": "env://"}
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    ctx = make_context(layout, dev)
    if rank == 0:
        result = fn(ctx, *args)
    else:
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            result = fn(ctx, *args)
    # Only after a clean run: a rank that raised exits at once (its peers may
    # be inside a collective, which a teardown would wait for). A captured
    # decode graph holding NCCL's collectives keeps its communicator alive
    # until the graph is freed (a model and its graph form a reference
    # cycle), and NCCL's teardown waits for that: collect it first.
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.destroy_process_group()
    return result


def _spawned_rank(rank: int, world: int, layout: Layout, backend: str, device: torch.device,
                  tmp: str, timeout_s: float) -> None:
    if device.type == "cpu":
        torch.set_num_threads(1)
    with open(os.path.join(tmp, _CALL), "rb") as f:
        fn, args = pickle.load(f)  # written by this run's parent
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    result = _run_rank(rank, world, layout, backend, device, rank, store, timeout_s, fn, args)
    path = os.path.join(tmp, _RESULT.format(rank))
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)


def launch(fn: Callable, *args, tp: int = 1, dp: int = 1, sp: int = 1, pp: int = 1,
           device="cuda", backend: Optional[str] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(ctx, *args)`` on the ranks of the layout ``(tp, dp, sp,
    pp)``; return each rank's result in rank order. Under ``torchrun`` this
    process is one rank: the list then holds its own result at its rank and
    None elsewhere."""
    layout = Layout(tp=tp, dp=dp, sp=sp, pp=pp)
    world = layout.world
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for and no card is present; pass device='cpu'")
    if under_torchrun():
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if size != world:
            raise ValueError(f"torchrun started {size} ranks for a world of {world} ({layout})")
        backend = choose_backend(device, 1, backend)
        local = int(os.environ["LOCAL_RANK"])
        if device.type == "cuda" and local == 0:
            from ..ops import _build

            _build.build_all()
        out: List[Any] = [None] * world
        # The other ranks wait in the process group's rendezvous meanwhile.
        out[rank] = _run_rank(rank, world, layout, backend, device, local, None, timeout_s,
                              fn, args)
        return out
    backend = choose_backend(device, world, backend)
    if device.type == "cuda":
        from ..ops import _build

        _build.build_all()
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="cct_ranks_")
    try:
        # fn and its arguments go through a file, not the spawn pipe: a rank
        # that died before reading a large pipe payload would leave the
        # parent blocked in its write.
        with open(os.path.join(tmp, _CALL), "wb") as f:
            pickle.dump((fn, args), f)
        procs = mp.start_processes(
            _spawned_rank, args=(world, layout, backend, device, tmp, timeout_s),
            nprocs=world, join=False, start_method="spawn")
        paths = [os.path.join(tmp, _RESULT.format(rank)) for rank in range(world)]
        done_at = None
        while not procs.join(timeout=1):  # raises when a rank fails
            if done_at is None and all(os.path.exists(p) for p in paths):
                done_at = time.monotonic()
            if done_at is not None and time.monotonic() - done_at > TEARDOWN_S:
                hung = [r for r, proc in enumerate(procs.processes) if proc.is_alive()]
                for proc in procs.processes:
                    if proc.is_alive():
                        proc.terminate()
                for proc in procs.processes:
                    proc.join(10)
                raise RuntimeError(
                    f"ranks {hung} wrote their results but did not exit within {TEARDOWN_S} s "
                    "(their process groups' teardown hung); they were stopped")
        results = []
        for path in paths:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_jobs(ctx, jobs) -> List[Any]:
    """Run ``jobs``, each ``(Layout, fn, args)``, one after another in one
    world of ranks (``launch(run_jobs, jobs, dp=world)``): each job calls
    ``fn(job_ctx, *args)`` on the first ranks of its layout with their
    context of it. Returns this rank's result of each job, None where it
    sat out; starting the ranks once saves their start-up per job."""
    out = []
    for layout, fn, args in jobs:
        job_ctx = make_context(layout, ctx.device)
        out.append(None if job_ctx is None else fn(job_ctx, *args))
    return out
