"""Process groups and collectives of the distributed path.

The JAX package runs partitioned execution as one SPMD program over a
``("parts",)`` device mesh (``shard_map``).  The port is
multi-controller instead: one process per shard (a *rank*) over
``torch.distributed``.  This module is the port's counterpart of that
mesh plumbing:

* **setup** — ``init_rank`` joins a process group through a file store,
  ``spawn`` starts one process per rank (start method ``"spawn"``) and
  returns every rank's result;
* **backend and device** — ``"nccl"`` on CUDA (rank ``r`` on
  ``cuda:r``), ``"gloo"`` on the CPU.  With more ranks than cards the
  call raises unless the caller asks for ``"gloo"``, whose ranks then
  share the cards (``cuda:r mod count``: one card, every rank on
  ``cuda:0``);
* **collectives** — ``Comm``: ``all_gather`` (``all_gather_into_tensor``),
  ``reduce_scatter`` and ``all_reduce_sum``, blocking or in flight
  (``*_start`` → ``Pending.wait()``).

Both reductions sum in rank order, so every rank gets the same bits and
a repeat run the same result: ``reduce_scatter`` is an ``all_to_all`` of
the blocks followed by a local sum over ranks 0, 1, …; ``all_reduce_sum``
an ``all_gather`` followed by the same sum.  They move the bytes a
``reduce_scatter`` / ``all_gather`` would.

**Host staging (gloo on CUDA tensors).**  ``Comm`` hands gloo CPU
tensors only: a CUDA operand is copied into a pinned host buffer, the
collective runs on the host, and its result is copied back to the card
(``Comm.staged``).  This is a transport — every SpMM and SDDMM still runs
on the card — and it is named as such in every figure taken from it.

Each process keeps the host seconds spent inside collectives (launch and
``wait()``), their calls and the bytes each rank receives, per
collective (``stats()``, ``reset_stats()``).
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo", "staged")
COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce")

_stats = {name: {"calls": 0, "seconds": 0.0, "bytes": 0}
          for name in COLLECTIVES}


def stats() -> dict:
    """Per collective: calls, host seconds inside them and bytes received
    by this rank, since the last ``reset_stats()``."""
    return {k: dict(v) for k, v in _stats.items()}


def reset_stats() -> None:
    for v in _stats.values():
        v.update(calls=0, seconds=0.0, bytes=0)


def _note(name: str, seconds: float, nbytes: int = 0, call: bool = False):
    s = _stats[name]
    s["seconds"] += seconds
    s["bytes"] += nbytes
    s["calls"] += int(call)


# ------------------------------------------------------ backend, device
def default_backend(device) -> str:
    """``"nccl"`` for CUDA, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_world(device, world: int, backend: str) -> None:
    """Raise unless ``world`` ranks can run on ``device`` over
    ``backend``: NCCL needs a card per rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        if backend == "nccl" and world > n:
            raise ValueError(
                f"{world} ranks over nccl need {world} CUDA devices, have "
                f"{n}; pass backend='gloo' to share the card(s)")
    elif backend == "nccl":
        raise ValueError("nccl runs on CUDA tensors only; use gloo on the "
                         "CPU")


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device of ``rank``: the CPU, or for CUDA ``cuda:rank`` over
    NCCL and ``cuda:(rank mod count)`` over gloo.  An explicit index
    (``"cuda:1"``) is kept."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda", rank if backend == "nccl" else rank % n)


# ------------------------------------------------------------- groups
def init_rank(rank: int, world: int, store_path: str, *,
              backend: str) -> None:
    """Join the default process group as ``rank`` of ``world`` through a
    ``FileStore`` at ``store_path``."""
    if backend == "staged":
        from . import staged  # noqa: F401  (registers the backend)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)


def _spawned(rank, fn, world, store_path, backend, device, threads,
             out_dir, args):
    torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device, rank, backend))
    init_rank(rank, world, store_path, backend=backend)
    try:
        res = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *, backend: str,
          device="cpu", threads: int | None = None) -> list:
    """Run ``fn(*args)`` on ``world`` new processes (start method
    ``"spawn"``), each rank inside the default process group over
    ``backend`` (a ``FileStore`` in a temporary directory), and return
    the ranks' results in rank order.  ``fn`` and ``args`` must pickle;
    ``threads`` (default: the host's cores over ``world``) is each
    rank's ``torch.set_num_threads``.  Raises if a rank fails."""
    import torch.multiprocessing as mp
    check_world(device, world, backend)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    with tempfile.TemporaryDirectory(prefix="repro_torch_dist_") as tmp:
        mp.start_processes(
            _spawned, args=(fn, world, os.path.join(tmp, "store"), backend,
                            device, threads, tmp, args),
            nprocs=world, start_method="spawn", join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


# -------------------------------------------------------- collectives
@dataclass
class Pending:
    """A collective in flight: ``wait()`` returns its result."""

    name: str
    work: object                   # the torch.distributed Work
    finish: Callable[[], torch.Tensor]

    def wait(self) -> torch.Tensor:
        t0 = time.perf_counter()
        self.work.wait()
        out = self.finish()
        _note(self.name, time.perf_counter() - t0)
        return out


def _sum_blocks(x: torch.Tensor, world: int) -> torch.Tensor:
    """Σ over the ``world`` leading blocks of ``x``, in block order."""
    blocks = x.reshape(world, -1, *x.shape[1:])
    out = blocks[0].clone()
    for r in range(1, world):
        out += blocks[r]
    return out


class Comm:
    """One rank's view of a process group (default: the world) and the
    collectives the distributed path runs, on CPU or CUDA tensors."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("no process group: call inside "
                               "torch.distributed.init_process_group (or "
                               "comm.spawn)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = dist.get_backend(group)

    def staged(self, x: torch.Tensor) -> bool:
        """True where ``x`` travels through a pinned host buffer: gloo
        on a CUDA tensor."""
        return self.backend == "gloo" and x.is_cuda

    def _host(self, x):
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)                        # waits for x on its stream
        return buf

    def _start(self, name, op, x, out_shape, finish):
        """Launch ``op(out, inp, group=, async_op=True)`` on ``x``
        (staged through the host where ``staged``); ``finish(out)`` runs
        on the result at ``wait()``."""
        t0 = time.perf_counter()
        x = x.contiguous()
        dev = x.device
        if self.staged(x):
            inp = self._host(x)
            out = torch.empty(out_shape, dtype=x.dtype, pin_memory=True)
            work = op(out, inp, group=self.group, async_op=True)
            done = lambda: finish(out.to(dev, non_blocking=True))
        else:
            out = torch.empty(out_shape, dtype=x.dtype, device=dev)
            work = op(out, x, group=self.group, async_op=True)
            done = lambda: finish(out)
        _note(name, time.perf_counter() - t0,
              out.numel() * out.element_size(), call=True)
        return Pending(name, work, done)

    # ------------------------------------------------------ all_gather
    def all_gather_start(self, x: torch.Tensor) -> Pending:
        """``all_gather_into_tensor``: every rank's ``x`` stacked along
        the leading axis in rank order, ``(world·n, ...)``."""
        return self._start("all_gather", dist.all_gather_into_tensor, x,
                           (self.world * x.shape[0], *x.shape[1:]),
                           lambda out: out)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_gather_start(x).wait()

    # -------------------------------------------------- reduce_scatter
    def reduce_scatter_start(self, x: torch.Tensor) -> Pending:
        """Block ``rank`` of ``Σ_ranks x``: ``x`` is ``(world·m, ...)``,
        the result ``(m, ...)``, summed in rank order."""
        if x.shape[0] % self.world:
            raise ValueError(f"reduce_scatter of {x.shape[0]} rows over "
                             f"{self.world} ranks")
        return self._start("reduce_scatter", dist.all_to_all_single, x,
                           tuple(x.shape),
                           lambda out: _sum_blocks(out, self.world))

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduce_scatter_start(x).wait()

    # ------------------------------------------------------ all_reduce
    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``Σ_ranks x`` on every rank, summed in rank order (the same
        bits everywhere)."""
        return self._start("all_reduce", dist.all_gather_into_tensor,
                           x.reshape(1, -1), (self.world, x.numel()),
                           lambda out: _sum_blocks(out, self.world)
                           .reshape(x.shape)).wait()

    def barrier(self) -> None:
        dist.barrier(group=self.group)
