"""A process-group backend that carries collectives of CUDA tensors over
gloo by staging them through pinned host buffers: the transport of the
LM mesh path when several ranks share one card.

NCCL refuses two ranks on one card, and gloo's own CUDA collectives are
not all there (a 4-rank probe on one H100 under torch 2.11 crashed a
rank).  ``init_process_group("staged", ...)`` (the name is registered
when this module is imported) gives every group of the job, the mesh's
sub-groups included, a ``StagedGroup``: it copies each CUDA operand
into a pinned host tensor, runs the collective on a gloo group over the
same store, and copies the result back to the card.  CPU operands go
straight to gloo.  Every kernel still runs on the card; only the bytes
of a collective cross the host, so every figure taken over it names the
transport (``NAME``).

The collectives DTensor issues map so (the functional collectives reach
a group through its ``*_coalesced`` entry points too):

* ``all_reduce`` (a ``Partial`` → ``Replicate``): gloo's allreduce;
* ``all_gather_into_tensor`` (``Shard`` → ``Replicate``): gloo's
  ``_allgather_base``;
* ``reduce_scatter_tensor`` (``Partial`` → ``Shard``): gloo's allreduce,
  then the rank's block;
* ``all_to_all_single`` (``Shard(i)`` → ``Shard(j)``): an all-gather of
  every rank's input, then the blocks addressed to this rank;
* ``broadcast`` and ``barrier``: gloo's.

Each rank keeps the calls, host seconds and bytes it received per kind
(``stats()``).
"""
from __future__ import annotations

import time
from datetime import timedelta

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import (AllgatherOptions, AllreduceOptions,
                                        AllToAllOptions, BarrierOptions,
                                        BroadcastOptions,
                                        ReduceScatterOptions,
                                        _create_work_from_future)
from torch.futures import Future

NAME = "staged"
TRANSPORT = ("gloo over pinned host buffers (every rank's kernels on the "
             "card; its collectives' bytes staged through the host)")
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "broadcast")

_stats = {k: {"calls": 0, "seconds": 0.0, "bytes": 0} for k in KINDS}


def stats() -> dict:
    return {k: dict(v) for k, v in _stats.items()}


def reset_stats() -> None:
    for v in _stats.values():
        v.update(calls=0, seconds=0.0, bytes=0)


def _done(result):
    fut = Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _host(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return x
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    return buf


def _back(dst: torch.Tensor, src: torch.Tensor) -> None:
    if dst is not src:
        dst.copy_(src)


class StagedGroup(dist.ProcessGroup):
    """One rank's group: collectives on gloo, CUDA operands staged."""

    def __init__(self, store, rank, world_size, timeout):
        super().__init__(rank, world_size)
        self._rank, self._world = rank, world_size
        self._gloo = dist.ProcessGroupGloo(store, rank, world_size, timeout)

    def getBackendName(self):
        return NAME

    # the group's name, kept on the Python side (c10d sets it after the
    # creator returns; the C++ field is not reached from a subclass)
    def _set_group_name(self, name):
        self._group_name = name

    @property
    def group_name(self):
        return self._group_name

    def size(self):
        return self._world

    def rank(self):
        return self._rank

    def _note(self, kind, t0, out):
        s = _stats[kind]
        s["calls"] += 1
        s["seconds"] += time.perf_counter() - t0
        s["bytes"] += out.numel() * out.element_size()

    # ------------------------------------------------------ all_reduce
    def _all_reduce(self, x, op):
        h = _host(x)
        if not h.is_contiguous():
            h = h.contiguous()
        opts = AllreduceOptions()
        opts.reduceOp = op
        self._gloo.allreduce([h], opts).wait()
        return h

    def allreduce(self, tensors, opts=AllreduceOptions()):
        for t in tensors:
            t0 = time.perf_counter()
            _back(t, self._all_reduce(t, opts.reduceOp))
            self._note("all_reduce", t0, t)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=AllreduceOptions()):
        return self.allreduce(tensors, opts)

    # ------------------------------------------------------ all_gather
    def _allgather_base(self, out, inp, opts=AllgatherOptions()):
        t0 = time.perf_counter()
        h_in = _host(inp.contiguous())
        h_out = (torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                 if out.is_cuda else out)
        self._gloo._allgather_base(h_out, h_in).wait()
        _back(out, h_out)
        self._note("all_gather", t0, out)
        return _done([out])

    def all_gather_single(self, out, inp, opts=AllgatherOptions()):
        return self._allgather_base(out, inp, opts)

    def allgather(self, outputs, inputs, opts=AllgatherOptions()):
        for outs, inp in zip(outputs, inputs):
            flat = torch.empty((self._world * inp.numel(),), dtype=inp.dtype,
                               device=inp.device)
            self._allgather_base(flat, inp.reshape(-1))
            for r, o in enumerate(outs):
                o.copy_(flat[r * inp.numel():(r + 1) * inp.numel()]
                        .view(o.shape))
        return _done(outputs)

    def allgather_into_tensor_coalesced(self, outs, inps,
                                        opts=AllgatherOptions()):
        for o, i in zip(outs, inps):
            self._allgather_base(o, i)
        return _done(outs)

    # -------------------------------------------------- reduce_scatter
    def _reduce_scatter_base(self, out, inp, opts=ReduceScatterOptions()):
        t0 = time.perf_counter()
        # gloo reduces in place: a CPU input is copied first (a CUDA one
        # is copied to the host anyway)
        full = self._all_reduce(inp if inp.is_cuda else inp.clone(),
                                opts.reduceOp)
        n = out.shape[0]
        _back(out, full[self._rank * n:(self._rank + 1) * n].to(out.device))
        self._note("reduce_scatter", t0, out)
        return _done([out])

    def reduce_scatter_single(self, out, inp, opts=ReduceScatterOptions()):
        return self._reduce_scatter_base(out, inp, opts)

    def reduce_scatter_tensor_coalesced(self, outs, inps,
                                        opts=ReduceScatterOptions()):
        for o, i in zip(outs, inps):
            self._reduce_scatter_base(o, i, opts)
        return _done(outs)

    # ------------------------------------------------------ all_to_all
    def alltoall_base(self, out, inp, out_splits, in_splits,
                      opts=AllToAllOptions()):
        t0 = time.perf_counter()
        w = self._world
        in_splits = list(in_splits) or [inp.shape[0] // w] * w
        # every rank's whole input, padded to the largest, then the
        # block each rank addressed to this one
        sizes = torch.tensor([inp.shape[0]] + in_splits, dtype=torch.int64)
        all_sizes = torch.empty((w, len(sizes)), dtype=torch.int64)
        self._gloo._allgather_base(all_sizes, sizes[None]).wait()
        rows = int(all_sizes[:, 0].max())
        pad = inp.new_zeros((rows, *inp.shape[1:]))
        pad[:inp.shape[0]] = inp
        h = _host(pad)
        gathered = torch.empty((w * rows, *inp.shape[1:]), dtype=inp.dtype)
        self._gloo._allgather_base(gathered, h).wait()
        pieces = []
        for r in range(w):
            off = int(all_sizes[r, 1:1 + self._rank].sum())
            n = int(all_sizes[r, 1 + self._rank])
            pieces.append(gathered[r * rows + off:r * rows + off + n])
        _back(out, torch.cat(pieces).to(out.device))
        self._note("all_to_all", t0, out)
        return _done([out])

    def all_to_all_single(self, out, inp, out_splits=(), in_splits=(),
                          opts=AllToAllOptions()):
        return self.alltoall_base(out, inp, out_splits, in_splits, opts)

    # ------------------------------------------------ broadcast, barrier
    def broadcast(self, tensors, opts=BroadcastOptions()):
        for t in tensors:
            t0 = time.perf_counter()
            h = _host(t.contiguous())
            bo = BroadcastOptions()
            bo.rootRank, bo.rootTensor = opts.rootRank, 0
            self._gloo.broadcast([h], bo).wait()
            _back(t, h)
            self._note("broadcast", t0, t)
        return _done(tensors)

    def barrier(self, opts=BarrierOptions()):
        self._gloo.barrier().wait()
        return _done([])


def _create(store, rank, world_size, timeout=timedelta(minutes=30)):
    return StagedGroup(store, rank, world_size, timeout)


if NAME not in dist.Backend.backend_list:
    dist.Backend.register_backend(NAME, _create, devices=["cpu", "cuda"])
