"""Halo feature exchange between ranks.

A shard's SpMM/SDDMM gathers source-node rows it does not own.  Rather
than all-gathering the full feature matrix (O(n·d) per rank), the
exchange is *compacted* on the host once per partition:

* ``send_idx[q]`` — the local row positions shard ``q`` contributes: the
  sorted union of every other shard's halo requests that ``q`` owns;
* ``halo_src[p]`` — for each of shard ``p``'s halo columns, the flat
  position of that row inside the all-gathered send buffer
  ``(P · max_send, d)``.

One ``all_gather`` of the packed send buffers per layer then serves both
SpMM and SDDMM on that shard (the gathered rows are concatenated after
the local block to form the extended column space the local PCSR
indexes).  The reverse path — scattering halo *gradients* back to their
owners — is the exact transpose: scatter-add into the flat buffer, a
``reduce_scatter`` (sum) down the ranks, and a local scatter-add at
``send_idx``.

``HaloExchange`` is that pair as one ``torch.autograd.Function``, so
autograd runs the scatter-back wherever a forward exchange fed a
differentiated result.  ``HaloPlan`` holds one rank's maps on its device
and splits each direction into a start and a finish, which the overlap
path issues around the local SpMM.

``halo_exchange_bytes_total{direction=gather|scatter}`` counts the bytes
of the all-gathered (resp. reduce-scattered) ``(P·max_send, d)`` buffer
on every call, while tracing is on (the JAX package counts once per
compiled program, at trace time).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.obs import metrics as _obs_metrics

from .partition import RowPartition


@dataclass
class HaloSpec:
    """Host-side compact exchange plan (numpy; one row per shard)."""

    n_parts: int
    max_send: int            # padded send-buffer rows per shard (≥ 1)
    max_halo: int            # padded halo width per shard (= part.halo_pad)
    send_idx: np.ndarray     # (P, max_send) int32 local rows to contribute
    n_send: np.ndarray       # (P,) true send counts
    halo_src: np.ndarray     # (P, max_halo) int32 flat gathered positions
    n_halo: np.ndarray       # (P,) true halo counts

    @property
    def gathered_rows(self) -> int:
        return self.n_parts * self.max_send


def build_halo(part: RowPartition) -> HaloSpec:
    """Compact send/recv maps from the partition's halo column lists."""
    P = part.n_parts
    requests = [s.halo_global for s in part.shards]
    all_req = (np.unique(np.concatenate(requests))
               if any(r.size for r in requests)
               else np.zeros(0, np.int64))
    owners = part.owner(all_req)
    send_rows = [all_req[owners == q] for q in range(P)]  # sorted global ids
    max_send = max(1, max((s.shape[0] for s in send_rows), default=1))

    send_idx = np.zeros((P, max_send), np.int32)
    n_send = np.zeros(P, np.int64)
    for q in range(P):
        k = send_rows[q].shape[0]
        send_idx[q, :k] = send_rows[q] - part.starts[q]   # local positions
        n_send[q] = k

    halo_src = np.zeros((P, part.halo_pad), np.int32)
    n_halo = np.zeros(P, np.int64)
    for p in range(P):
        halo = requests[p]
        if halo.size:
            own = part.owner(halo)
            pos = np.empty(halo.shape[0], np.int64)
            for q in range(P):
                sel = own == q
                if sel.any():
                    # rank of each requested row in its owner's send list
                    pos[sel] = (q * max_send
                                + np.searchsorted(send_rows[q], halo[sel]))
            halo_src[p, :halo.shape[0]] = pos
        n_halo[p] = halo.shape[0]
    return HaloSpec(P, max_send, part.halo_pad, send_idx, n_send,
                    halo_src, n_halo)


class HaloPlan:
    """One rank's side of a ``HaloSpec`` on its device, and the two
    directions of the exchange over ``comm`` (a ``comm.Comm``)."""

    def __init__(self, spec: HaloSpec, rank: int, rows_pad: int, comm,
                 device):
        self.comm = comm
        self.rows_pad = rows_pad
        self.max_send = spec.max_send
        self.max_halo = spec.max_halo
        self.gathered_rows = spec.gathered_rows
        as_idx = lambda a: torch.as_tensor(a, dtype=torch.int64,
                                           device=device)
        self.send_idx = as_idx(spec.send_idx[rank])
        self.halo_src = as_idx(spec.halo_src[rank])
        # the real entries only: padded entries alias row / position 0 and
        # carry nothing, so the scatters add no duplicate index
        self.send_real = as_idx(spec.send_idx[rank, :spec.n_send[rank]])
        self.halo_real = as_idx(spec.halo_src[rank, :spec.n_halo[rank]])
        self.n_halo = int(spec.n_halo[rank])

    def _count(self, x, direction):
        _obs_metrics.counter("halo_exchange_bytes_total").inc(
            self.gathered_rows * x.shape[-1] * x.element_size(),
            direction=direction)

    # ------------------------------------------------ forward: gather
    def start(self, b: torch.Tensor):
        """Launch the exchange of ``b`` ``(rows_pad, d)``: the send rows,
        all-gathered."""
        self._count(b, "gather")
        return self.comm.all_gather_start(b.index_select(0, self.send_idx))

    def finish(self, full: torch.Tensor) -> torch.Tensor:
        """The ``(max_halo, d)`` halo rows of a landed gather (padded
        entries repeat flat position 0; no edge reads them)."""
        return full.index_select(0, self.halo_src)

    def gather(self, b: torch.Tensor) -> torch.Tensor:
        return self.finish(self.start(b).wait())

    # -------------------------------------------- backward: scatter-back
    def scatter_start(self, d_halo: torch.Tensor):
        """Launch the transpose of ``gather`` on halo gradients
        ``(max_halo, d)``: scatter into the flat gathered layout, then a
        ``reduce_scatter`` hands each rank the sums for its send rows."""
        self._count(d_halo, "scatter")
        buf = d_halo.new_zeros((self.gathered_rows, d_halo.shape[-1]))
        buf.index_add_(0, self.halo_real, d_halo[:self.n_halo])
        return self.comm.reduce_scatter_start(buf)

    def scatter_finish(self, own: torch.Tensor,
                       into: torch.Tensor | None = None) -> torch.Tensor:
        """Add the landed ``(max_send, d)`` sums onto their owners' rows:
        into ``into`` ``(rows_pad, d)`` in place, or into zeros."""
        if into is None:
            into = own.new_zeros((self.rows_pad, own.shape[-1]))
        return into.index_add_(0, self.send_real,
                               own[:self.send_real.shape[0]])

    def scatter_back(self, d_halo: torch.Tensor) -> torch.Tensor:
        return self.scatter_finish(self.scatter_start(d_halo).wait())


class HaloExchange(torch.autograd.Function):
    """``b (rows_pad, d) → halo rows (max_halo, d)``; backward, the
    scatter-back of the halo gradients to their owners' rows."""

    @staticmethod
    def forward(ctx, b, plan: HaloPlan):
        ctx.plan = plan
        return plan.gather(b)

    @staticmethod
    def backward(ctx, d_halo):
        return ctx.plan.scatter_back(d_halo.contiguous()), None


def halo_exchange(b: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
    """Differentiable forward exchange: local rows → halo rows."""
    return HaloExchange.apply(b, plan)


def halo_scatter_back(d_halo: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
    """Reverse exchange: halo gradients ``(max_halo, d)`` → a
    ``(rows_pad, d)`` gradient on their owners' rows."""
    return plan.scatter_back(d_halo)
