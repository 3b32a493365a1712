"""Incremental PCSR maintenance: exact SpMM under edge mutation without
full re-packs.

``DynamicPCSR`` wraps a packed :class:`repro_torch.core.pcsr.PCSR` and
absorbs batched edge inserts and deletes by editing steering arrays only:

* **slack slots** — an insert first lands in a padding slot of a chunk
  already targeting its output block (capacity roundup, V padding and
  earlier tombstones all leave ``vals == 0`` holes the kernels multiply
  by zero);
* **delta chunks** — when a block has no free slot left, a fresh
  all-padding chunk targeting it is appended to storage; a block nothing
  targeted before is *born* the same way;
* **tombstones** — a delete zeroes the edge's value cell.  A vector whose
  cells are all zero contributes nothing on any path (the SpMM multiplies
  by 0, both SDDMM kernels mask ``vals == 0`` per cell, the GAT prologue
  carries −inf logits there), so its slot returns to the block's free
  list.

Storage is append-ordered; the kernels need each block's chunks
contiguous, so the kernel-facing view (``.pcsr``) is built lazily through
a grouping permutation: chunks sorted by the first storage position of
their block, stable within a block.  That keeps the base pack's emit
order (ascending, or LPT under ``B``) and appends new blocks' groups at
the tail.  The view and every layout array are array-equal with the JAX
package's ``DynamicPCSR`` after the same mutation stream, down to which
free slot each insert claims (per-block LIFO free lists).

Host-side numpy throughout.  The bookkeeping is built vectorised: the
live vectors of the base pack are a sorted key array (looked up a batch
at a time with ``searchsorted``) under a dict of the keys mutated since,
and the free lists come from one stable sort; ``to_csr`` reads the live
cells straight out of storage.  Only the per-edge insert/delete loops are
Python, because which slot an insert claims depends on every earlier
edge of its batch.  Delta chunks grow storage by doubling, so a batch
that appends many costs amortised O(1) per chunk.

Results stay exact at every moment: the live arrays encode the mutated
edge set; only the layout's speed degrades until the governor
(:mod:`repro_torch.dynamic.governor`) prices a re-pack.  An edge value of
exactly 0 is not representable (a zero cell *is* a padding slot), so
``insert_edges`` rejects it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.pcsr import (PCSR, SpMMConfig, build_pcsr,
                                   pcsr_slot_coords)
from repro_torch.core.sparse import CSRMatrix
from repro_torch.obs import metrics as _obs_metrics


@dataclass
class MutationReport:
    """Where one batch of edge mutations landed."""

    inserted: int = 0          # new edges added
    updated: int = 0           # existing edges whose value changed
    deleted: int = 0           # edges removed
    slack_inserts: int = 0     # inserts absorbed by existing slots
    delta_chunks: int = 0      # fresh chunks appended for overflow
    tombstones: int = 0        # vectors fully zeroed by deletes
    missing: int = 0           # deletes of edges that did not exist


class DynamicPCSR:
    """A PCSR that takes edge insert/delete batches in place.

    Construct from a packed ``PCSR`` (or ``DynamicPCSR.from_csr``), call
    ``insert_edges`` / ``delete_edges``, and read ``.pcsr``: a normal
    ``PCSR`` every kernel and operator consumes unchanged.  ``version``
    moves on every effective mutation, so callers holding operators over
    a view know when to rebuild them.
    """

    def __init__(self, base: PCSR):
        cfg = base.config
        self.config: SpMMConfig = cfg
        self.n_rows, self.n_cols = base.n_rows, base.n_cols
        self.n_blocks, self.K = base.n_blocks, base.K
        self.V, self.W, self.R = cfg.V, cfg.W, cfg.R
        K = base.K
        # storage, append-ordered, the first ``_C`` chunks live:
        # (C, K) steering + (C, V, K) vals
        self._C = base.num_chunks
        self._colidx = base.colidx.reshape(-1, K).copy()
        self._lrow = base.lrow.reshape(-1, K).copy()
        self._trow = base.trow.astype(np.int64)
        self._vals = base.vals.copy()
        # live vectors, keyed panel·n_cols + col, at flat slots c·K + k:
        # the base pack's as sorted arrays, the keys mutated since in a
        # dict (slot, or −1 once the vector is gone); per block its free
        # slots (padding + tombstoned), ascending, popped from the end
        rows, cols, flat = pcsr_slot_coords(base)
        slot = (flat // (self.V * K)) * K + flat % K
        keys = (rows // self.V) * self.n_cols + cols
        keys, at = np.unique(keys, return_index=True)   # V cells, 1 slot
        self._keys, self._slots = keys, slot[at]
        self._moved: dict[int, int] = {}
        occ = np.zeros(self._C * K, bool)
        occ[slot] = True
        free = np.flatnonzero(~occ)
        blk = self._trow[free // K]
        order = np.argsort(blk, kind="stable")
        blocks, first = np.unique(blk[order], return_index=True)
        self._free: dict[int, list[int]] = dict(zip(
            blocks.tolist(),
            (a.tolist() for a in np.split(free[order], first[1:]))))
        self.nnz = base.nnz
        self.nnz_vec = int(keys.size)
        self.base_num_chunks = base.num_chunks
        self.version = 0
        self.n_slack_inserts = 0
        self.n_delta_chunks = 0
        self.n_tombstones = 0
        self._view: PCSR | None = None
        self._csr: CSRMatrix | None = None

    @classmethod
    def from_csr(cls, csr: CSRMatrix, config: SpMMConfig) -> "DynamicPCSR":
        return cls(build_pcsr(csr.indptr, csr.indices, csr.data,
                              csr.n_rows, csr.n_cols, config))

    # ------------------------------------------------------------ stats
    @property
    def num_chunks(self) -> int:
        return self._C

    @property
    def num_slots(self) -> int:
        return self.num_chunks * self.K

    @property
    def n_visited_blocks(self) -> int:
        """Distinct blocks the live chunks target (bounds output traffic
        in the degraded grid; fully tombstoned blocks included)."""
        return int(np.count_nonzero(np.bincount(
            self._trow[:self._C], minlength=self.n_blocks)))

    @property
    def n_nonempty_blocks(self) -> int:
        """Blocks holding at least one live vector."""
        C = self._C
        live = self._vals[:C].reshape(C, -1).any(axis=1)
        return int(np.count_nonzero(np.bincount(
            self._trow[:C][live], minlength=self.n_blocks)))

    @property
    def padding_ratio(self) -> float:
        """PR_V over the live edge set (paper Eq. 2)."""
        if self.nnz_vec == 0:
            return 0.0
        return 1.0 - self.nnz / (self.nnz_vec * self.V)

    @property
    def slot_fill(self) -> float:
        """Fraction of storage slots holding a live vector: what decays as
        tombstones and delta-chunk padding accumulate."""
        return self.nnz_vec / max(1, self.num_slots)

    # ------------------------------------------------------- mutations
    def _base_slots(self, keys: np.ndarray) -> list:
        """The base pack's slot of each key (−1: not a base vector)."""
        if not self._keys.size:
            return [-1] * keys.size
        pos = np.minimum(np.searchsorted(self._keys, keys),
                         self._keys.size - 1)
        return np.where(self._keys[pos] == keys, self._slots[pos],
                        -1).tolist()

    def _append_chunk(self, block: int) -> int:
        """A fresh all-padding chunk targeting ``block``; storage doubles
        when full."""
        c = self._C
        if c == self._trow.shape[0]:
            grow = max(c, 8)
            self._colidx = np.concatenate(
                [self._colidx, np.zeros((grow, self.K), np.int32)])
            self._lrow = np.concatenate(
                [self._lrow, np.zeros((grow, self.K), np.int32)])
            self._trow = np.concatenate([self._trow,
                                         np.zeros(grow, np.int64)])
            self._vals = np.concatenate(
                [self._vals, np.zeros((grow, self.V, self.K), np.float32)])
        self._trow[c] = block
        self._C = c + 1
        return c

    def _claim_slot(self, block: int) -> int:
        """A free slot in a chunk targeting ``block``: slack first, a
        delta chunk only when the block is full."""
        free = self._free.get(block)
        if free:
            self.n_slack_inserts += 1
            return free.pop()
        c = self._append_chunk(block)
        K = self.K
        self._free[block] = list(range(c * K + K - 1, c * K, -1))
        self.n_delta_chunks += 1
        return c * K

    def insert_edges(self, rows, cols, values) -> MutationReport:
        """Insert (or update) a batch of edges.  Exact immediately: the
        next ``.pcsr`` view encodes the new edge set bit for bit."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        values = np.asarray(values, np.float32)
        if rows.shape != cols.shape or rows.shape != values.shape:
            raise ValueError("rows/cols/values must match in length")
        if (values == 0).any():
            raise ValueError("cannot insert an edge with value exactly 0 "
                             "(a zero cell is a padding slot)")
        if rows.size and (rows.min() < 0 or rows.max() >= self.n_rows
                          or cols.min() < 0 or cols.max() >= self.n_cols):
            raise ValueError("edge endpoints out of range — the dynamic "
                             "layer mutates edges over a fixed node set")
        rep = MutationReport()
        slack0, delta0 = self.n_slack_inserts, self.n_delta_chunks
        V, W, K = self.V, self.W, self.K
        moved = self._moved
        panels = rows // V
        keys = panels * self.n_cols + cols
        for key, base_s, panel, v_off, col, val in zip(
                keys.tolist(), self._base_slots(keys), panels.tolist(),
                (rows - panels * V).tolist(), cols.tolist(),
                values.tolist()):
            s = moved.get(key, base_s)
            if s < 0:
                block = panel // W
                s = self._claim_slot(block)
                c, k = divmod(s, K)
                self._colidx[c, k] = col
                self._lrow[c, k] = panel - block * W
                moved[key] = s
                self.nnz_vec += 1
            c, k = divmod(s, K)
            if self._vals[c, v_off, k] != 0.0:
                rep.updated += 1
            else:
                rep.inserted += 1
                self.nnz += 1
            self._vals[c, v_off, k] = val
        rep.slack_inserts = self.n_slack_inserts - slack0
        rep.delta_chunks = self.n_delta_chunks - delta0
        if rep.slack_inserts:
            _obs_metrics.counter("dynamic_slack_inserts_total").inc(
                rep.slack_inserts)
        if rep.delta_chunks:
            _obs_metrics.counter("dynamic_delta_chunks_total").inc(
                rep.delta_chunks)
        self._committed(rep, rows.size)
        return rep

    def delete_edges(self, rows, cols) -> MutationReport:
        """Delete a batch of edges by tombstoning their value cells.
        Deleting an edge that does not exist is counted, not an error
        (streams replay)."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        rep = MutationReport()
        V, W, K = self.V, self.W, self.K
        moved, vals = self._moved, self._vals
        panels = rows // V
        keys = panels * self.n_cols + cols
        for key, base_s, panel, v_off in zip(
                keys.tolist(), self._base_slots(keys), panels.tolist(),
                (rows - panels * V).tolist()):
            s = moved.get(key, base_s)
            if s < 0:
                rep.missing += 1
                continue
            c, k = divmod(s, K)
            if vals[c, v_off, k] == 0.0:
                rep.missing += 1
                continue
            vals[c, v_off, k] = 0.0
            rep.deleted += 1
            self.nnz -= 1
            if V == 1 or not vals[c, :, k].any():       # whole vector gone
                moved[key] = -1
                self.nnz_vec -= 1
                rep.tombstones += 1
                self._free.setdefault(panel // W, []).append(s)
        self.n_tombstones += rep.tombstones
        if rep.tombstones:
            _obs_metrics.counter("dynamic_tombstones_total").inc(
                rep.tombstones)
        self._committed(rep, rows.size)
        return rep

    def _committed(self, rep: MutationReport, batch: int) -> None:
        if rep.inserted or rep.updated or rep.deleted:
            self.version += 1
            self._view = None
            self._csr = None
        _obs_metrics.counter("dynamic_mutations_total").inc(
            batch, kind="insert" if rep.deleted == 0 else "delete")

    # ----------------------------------------------------------- views
    @property
    def pcsr(self) -> PCSR:
        """The kernel-facing grouped view (cached until the next
        mutation)."""
        if self._view is None:
            C = self._C
            trow = self._trow[:C]
            first = np.full(self.n_blocks, C, np.int64)
            blocks, at = np.unique(trow, return_index=True)
            first[blocks] = at
            order = np.argsort(first[trow], kind="stable")
            trow = trow[order].astype(np.int32)
            init = np.ones(C, np.int32)
            init[1:] = (trow[1:] != trow[:-1]).astype(np.int32)
            self._view = PCSR(
                self.config, self.n_rows, self.n_cols, self.n_blocks,
                self.K, self._colidx[:C][order].reshape(-1),
                self._lrow[:C][order].reshape(-1), trow, init,
                self._vals[:C][order], self.nnz, self.nnz_vec,
                self.n_nonempty_blocks)
        return self._view

    def to_csr(self) -> CSRMatrix:
        """The mutated edge set as a CSR (the re-pack and verify path),
        read from the live cells of storage; cached until the next
        mutation, so do not modify it."""
        if self._csr is None:
            C = self._C
            c, v, k = np.nonzero(self._vals[:C])
            rows = ((self._trow[c] * self.W + self._lrow[c, k]) * self.V
                    + v)
            self._csr = CSRMatrix.from_coo(
                rows, self._colidx[c, k], self._vals[c, v, k], self.n_rows,
                self.n_cols, sum_duplicates=False)
        return self._csr

    def reselect(self, config: SpMMConfig) -> None:
        """Swap the config without re-packing.  Only ``F`` (the feature
        tile width) is layout-free; the packing axes ⟨V, W, S, B⟩ must
        match the arrays in storage."""
        if (config.V, config.W, config.S, config.B) != \
                (self.V, self.W, self.config.S, self.config.B):
            raise ValueError(
                f"reselect may only change F: layout is packed for "
                f"{self.config.astuple()}, got {config.astuple()} — "
                f"use repack() for V/W/S/B changes")
        if config != self.config:
            self.config = config
            self.version += 1
            self._view = None

    def repack(self, config: SpMMConfig | None = None) -> PCSR:
        """Full re-pack from the live edge set: clears every slack,
        tombstone and delta-chunk debt (optionally under a new config) and
        re-seats this ``DynamicPCSR`` on the fresh layout."""
        csr = self.to_csr()
        fresh = build_pcsr(csr.indptr, csr.indices, csr.data,
                           csr.n_rows, csr.n_cols, config or self.config)
        _obs_metrics.counter("dynamic_repacks_total").inc(
            config=str((config or self.config).astuple()))
        version = self.version
        self.__init__(fresh)
        self.version = version + 1
        return fresh
