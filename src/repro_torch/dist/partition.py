"""1D row partitioning of a CSR adjacency for multi-rank execution.

The graph's rows (= destination nodes) are split into ``n_parts``
contiguous ranges; shard ``p`` owns rows ``[starts[p], starts[p+1])`` and
the matching slice of every node-aligned array (features, labels,
gradients).  Because the split is by *row*, every nonzero of A lands in
exactly one shard — the shard owning its destination row — so SpMM's
scatter side is purely local and only the gather side (columns = source
nodes) crosses shards.

Each shard's columns split into

* **local** columns (sources the shard owns): renumbered ``j - start_p``;
* **halo** columns (sources owned by other shards): the sorted unique
  remote ids become a compact *halo index map* ``halo_global``; halo
  column ``g`` is renumbered ``rows_pad + rank(g)``.

All shards share one ``rows_pad`` row count and ``halo_pad`` halo width,
so the halo exchange's buffers have one shape on every rank (an
``all_gather`` needs equal sizes); the padding never aliases real data —
padded rows have no nonzeros and padded halo columns are referenced by
no edge.

Two strategies:

* ``"contiguous"`` — equal row counts (the trivial split);
* ``"balanced"``   — boundaries chosen on the cumulative-nnz curve so
  shards carry ~equal nonzeros (on power-law graphs equal-row shards
  differ by orders of magnitude in work).

Host numpy only, array-equal with the JAX package's partitioner.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.sparse import CSRMatrix

STRATEGIES = ("contiguous", "balanced")


@dataclass
class Shard:
    """One row-range of the global graph, in local (extended-column)
    coordinates."""

    part: int
    start: int               # global row range [start, stop)
    stop: int
    csr: CSRMatrix           # (rows_pad, rows_pad + halo_pad) local CSR
    halo_global: np.ndarray  # (n_halo,) sorted global ids of halo columns
    n_halo: int

    @property
    def n_local_rows(self) -> int:
        return self.stop - self.start


@dataclass
class RowPartition:
    """The full partition plan: boundaries + per-shard local CSRs."""

    n_parts: int
    n_global: int
    strategy: str
    starts: np.ndarray       # (n_parts+1,) global row boundaries
    rows_pad: int            # uniform padded local row count
    halo_pad: int            # uniform padded halo width (≥ 1)
    shards: list

    @property
    def ext_cols(self) -> int:
        """Width of the per-shard extended column space (local + halo)."""
        return self.rows_pad + self.halo_pad

    def owner(self, g):
        """Shard owning global row(s) ``g``."""
        return np.searchsorted(self.starts[1:-1], np.asarray(g), side="right")

    def pad_position(self, g):
        """Position of global row(s) ``g`` in the (P·rows_pad) layout that
        stacks every shard's padded block in shard order."""
        own = self.owner(g)
        return own * self.rows_pad + (np.asarray(g) - self.starts[own])


def partition_bounds(csr: CSRMatrix, n_parts: int,
                     strategy: str = "balanced") -> np.ndarray:
    """Row boundaries (n_parts+1,) for the chosen strategy."""
    n = csr.n_rows
    if n_parts < 1 or n_parts > max(1, n):
        raise ValueError(f"n_parts={n_parts} invalid for {n} rows")
    if strategy == "contiguous":
        per = -(-n // n_parts)
        starts = np.minimum(np.arange(n_parts + 1, dtype=np.int64) * per, n)
    elif strategy == "balanced":
        targets = np.linspace(0, csr.nnz, n_parts + 1)[1:-1]
        inner = np.searchsorted(csr.indptr, targets, side="left")
        starts = np.concatenate([[0], inner, [n]]).astype(np.int64)
        starts = np.maximum.accumulate(starts)
    else:
        raise ValueError(f"strategy must be one of {STRATEGIES}")
    return starts


def partition_csr(csr: CSRMatrix, n_parts: int,
                  strategy: str = "balanced", *, starts=None,
                  halo_pad_min: int = 1) -> RowPartition:
    """Split ``csr`` into per-shard local CSRs with halo column maps.

    ``starts`` pins explicit row boundaries instead of recomputing them;
    ``halo_pad_min`` floors the padded halo width (a re-slice of a
    mutated graph under an existing partition keeps its shapes while
    its halos still fit the old pad).
    """
    if csr.n_rows != csr.n_cols:
        raise ValueError("row partitioning expects a square adjacency")
    if starts is None:
        starts = partition_bounds(csr, n_parts, strategy)
    else:
        starts = np.asarray(starts, np.int64)
        if starts.shape != (n_parts + 1,) or starts[0] != 0 \
                or starts[-1] != csr.n_rows:
            raise ValueError(f"starts must be (n_parts+1,) boundaries "
                             f"over [0, {csr.n_rows}]")
    rows_pad = int(np.max(np.diff(starts))) if n_parts else 0
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64), csr.degrees)

    # first pass: per-shard edge slices (CSR rows are sorted ⇒ contiguous)
    slices, halos = [], []
    for p in range(n_parts):
        lo, hi = int(starts[p]), int(starts[p + 1])
        sel = slice(int(csr.indptr[lo]), int(csr.indptr[hi]))
        cols = csr.indices[sel]
        remote = cols[(cols < lo) | (cols >= hi)]
        halos.append(np.unique(remote))
        slices.append((lo, hi, sel))
    halo_pad = max(1, int(halo_pad_min),
                   max((h.shape[0] for h in halos), default=1))

    shards = []
    for p, (lo, hi, sel) in enumerate(slices):
        halo = halos[p]
        r = rows[sel] - lo
        c = csr.indices[sel]
        d = csr.data[sel]
        local = (c >= lo) & (c < hi)
        lc = np.where(local, c - lo,
                      rows_pad + np.searchsorted(halo, c))
        shard_csr = CSRMatrix.from_coo(r, lc, d, rows_pad,
                                       rows_pad + halo_pad,
                                       sum_duplicates=False)
        shards.append(Shard(p, lo, hi, shard_csr, halo,
                            int(halo.shape[0])))
    return RowPartition(n_parts, csr.n_rows, strategy, starts,
                        rows_pad, halo_pad, shards)


def unpartition_rows(part: RowPartition, stacked: np.ndarray) -> np.ndarray:
    """Inverse of the stacked padded layout: (P·rows_pad, ...) →
    (n_global, ...)."""
    idx = part.pad_position(np.arange(part.n_global, dtype=np.int64))
    return np.asarray(stacked)[idx]


def split_local_halo(shard: Shard, part: RowPartition):
    """Split a shard's local CSR into its **local** and **halo** edge sets
    — the decomposition the overlap path executes.

    * ``local`` — ``(rows_pad, rows_pad)``, owned columns only;
    * ``halo``  — ``(rows_pad, halo_pad)``, halo columns renumbered to
      ``[0, halo_pad)`` so the gathered ``(max_halo, d)`` buffer is its
      operand directly;

    so ``A_p·B_ext = local·B_loc + halo·B_halo``: the local SpMM does not
    depend on the exchange and runs while it is in flight.  Each part
    gets its own config (the halo part of a power-law shard is typically
    far sparser than the local part).
    """
    csr = shard.csr
    rows_pad, halo_pad = part.rows_pad, part.halo_pad
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64), csr.degrees)
    local = csr.indices < rows_pad
    loc = CSRMatrix.from_coo(rows[local], csr.indices[local],
                             csr.data[local], rows_pad, rows_pad,
                             sum_duplicates=False)
    halo = CSRMatrix.from_coo(rows[~local], csr.indices[~local] - rows_pad,
                              csr.data[~local], rows_pad, halo_pad,
                              sum_duplicates=False)
    return loc, halo
