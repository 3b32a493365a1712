"""Per-shard drift detection and selective re-pack for ``DistGraph``.

The partitioned counterpart of the single-device governor.  A mutated
global adjacency is re-sliced under the same row boundaries
(``partition_csr(..., starts=part.starts)``) and the same padded halo
width (``halo_pad_min``), so

* shards whose local edge set did not change come out bit-identical and
  keep their ``Shard`` objects — and, on the rank that owns one, its
  ``ShardPack`` with the device ``Steering`` of every pack in it;
* shards whose edges changed are re-packed, under their config, or under
  a fresh ``CostModel.best`` pick on the new local CSR when the shard's
  feature snapshot drifted past the thresholds (the per-shard form of a
  re-pick);
* the halo maps (``HaloSpec``, and a bound rank's ``HaloPlan``) are
  rebuilt and the cached GAT closures dropped.  When a mutated halo
  outgrows the old ``halo_pad``, every shard's extended column space
  widens and every shard rebuilds (``halo_pad_grew``).

One process per shard: every rank computes the same host plan from the
same ``new_csr`` — the re-slice, the drift check and any re-pick of every
shard — so ``configs`` and the report are identical on every rank; each
rank then re-packs only its own shard (with the overlap path's local and
halo packs) if that shard changed.

Entry point: ``refresh_dist_graph(g, new_csr)``, also
``DistGraph.refresh``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.cost_model import CostModel
from repro_torch.core.pcsr import config_space
from repro_torch.core.sparse import CSRMatrix
from repro_torch.obs import metrics as _obs_metrics, trace as _obs_trace
from repro_torch.obs.decisions import (DecisionRecord, DriftAdvisory,
                                       check_drift, graph_snapshot)


def _same_shard_csr(a: CSRMatrix, b: CSRMatrix) -> bool:
    return (a.nnz == b.nnz and a.n_cols == b.n_cols
            and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def _shard_drift(g, old_csr: CSRMatrix, new_csr: CSRMatrix, config,
                 threshold) -> Optional[DriftAdvisory]:
    rec = DecisionRecord(
        source="dist_shard", op="spmm", dim=g.dim, heads=g.heads,
        chosen=config.astuple(), predicted_seconds=None, topk=[],
        snapshot=graph_snapshot(old_csr), calibration=None)
    return check_drift(new_csr, record=rec, threshold=threshold)


def shard_drift(g, new_csr: CSRMatrix, *, threshold=None
                ) -> dict[int, Optional[DriftAdvisory]]:
    """Per-shard drift of a mutated global CSR against the local
    subgraphs ``g`` packed: re-slices ``new_csr`` under ``g``'s own
    boundaries and compares each *changed* shard's snapshot.  Returns
    ``{shard: advisory_or_None}`` for the changed shards only (``None``:
    changed without crossing a threshold)."""
    from repro_torch.dist.partition import partition_csr

    part = g.part
    new_part = partition_csr(new_csr, part.n_parts, part.strategy,
                             starts=part.starts,
                             halo_pad_min=part.halo_pad)
    out: dict[int, Optional[DriftAdvisory]] = {}
    for p in range(part.n_parts):
        old_s, new_s = part.shards[p], new_part.shards[p]
        if _same_shard_csr(old_s.csr, new_s.csr):
            continue
        out[p] = _shard_drift(g, old_s.csr, new_s.csr, g.configs[p],
                              threshold)
    return out


@dataclass
class ShardRefreshReport:
    """What one ``refresh_dist_graph`` pass rebuilt."""

    changed: list = field(default_factory=list)    # shards with new edges
    repicked: list = field(default_factory=list)   # drifted → new config
    reused: list = field(default_factory=list)     # kept as they were
    advisories: dict = field(default_factory=dict)  # shard -> DriftAdvisory
    halo_pad_grew: bool = False


def refresh_dist_graph(g, new_csr: CSRMatrix, *, threshold=None,
                       max_f: int = 4) -> ShardRefreshReport:
    """Swap a mutated adjacency into a live ``DistGraph``, re-packing
    only the shards whose local subgraph changed.

    Unchanged shards keep their ``Shard`` (and on their rank the
    ``ShardPack``) by identity; changed shards rebuild under their
    config, or under a fresh ``CostModel.best`` pick (over
    ``config_space(dim, max_f)`` on ``g.hardware`` or ``g.calibration``)
    when their snapshot drifted past ``threshold`` (per-feature dict,
    scalar or ``$REPRO_DRIFT_THRESHOLD``).  The halo maps are rebuilt and
    the cached GAT closures dropped; the boundaries and padded shapes
    survive unless ``halo_pad`` outgrows its old value (then every shard
    rebuilds).  Needs no process group: without one, only the host plan
    is refreshed.
    """
    from repro_torch.dist.halo import HaloPlan, build_halo
    from repro_torch.dist.packing import pack_shard
    from repro_torch.dist.partition import partition_csr, split_local_halo

    if new_csr.n_rows != g.part.n_global:
        raise ValueError("refresh mutates edges over a fixed node set — "
                         f"got {new_csr.n_rows} rows for a "
                         f"{g.part.n_global}-row partition")
    old_part = g.part
    P = old_part.n_parts
    rep = ShardRefreshReport()
    cost = lambda m: CostModel(m, g.hardware, calibration=g.calibration)
    with _obs_trace.span("dynamic.shard_repack", n_parts=P):
        new_part = partition_csr(new_csr, P, old_part.strategy,
                                 starts=old_part.starts,
                                 halo_pad_min=old_part.halo_pad)
        rep.halo_pad_grew = new_part.halo_pad > old_part.halo_pad
        configs = list(g.configs)
        space = config_space(g.dim, max_f)
        for p in range(P):
            old_s, new_s = old_part.shards[p], new_part.shards[p]
            if not rep.halo_pad_grew and _same_shard_csr(old_s.csr,
                                                         new_s.csr):
                new_part.shards[p] = old_s       # identity-preserving
                rep.reused.append(p)
                continue
            rep.changed.append(p)
            adv = _shard_drift(g, old_s.csr, new_s.csr, configs[p],
                               threshold)
            if adv is not None:
                rep.advisories[p] = adv
                configs[p], _ = cost(new_s.csr).best(g.dim, space,
                                                     H=g.heads)
                rep.repicked.append(p)
            _obs_metrics.counter("dist_shard_repacks_total").inc(
                shard=p, repicked=adv is not None)
        if g.overlap:
            for p in rep.changed:
                loc, hal = split_local_halo(new_part.shards[p], new_part)
                g._split_csrs[p] = (loc, hal)
                if p in rep.repicked:
                    g.overlap_configs[p] = (
                        cost(loc).best(g.dim, space, H=g.heads)[0],
                        cost(hal).best(g.dim, space, H=g.heads)[0])
        g.part = new_part
        g.csr = new_csr
        g.configs = configs
        g.halo = build_halo(new_part)
        g._gat_fns = {}
        if g.pack is not None:               # this rank's own shard
            r = g.rank
            if r in rep.changed:
                split = split_configs = None
                if g.overlap:
                    split, split_configs = (g._split_csrs[r],
                                            g.overlap_configs[r])
                with _obs_trace.span("dist.pack", n_parts=P, rank=r):
                    g.pack = pack_shard(new_part.shards[r].csr, configs[r],
                                        g.device, split=split,
                                        split_configs=split_configs)
            g.halo_plan = HaloPlan(g.halo, r, new_part.rows_pad, g.comm,
                                   g.device)
    return rep
