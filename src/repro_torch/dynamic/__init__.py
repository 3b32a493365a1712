"""Dynamic graphs: incremental PCSR maintenance with drift-driven
self-healing re-pack and re-selection.

Production graphs mutate under traffic; the steering arrays and the
⟨W,F,V,S,B⟩ pick were chosen for a graph that no longer exists.  This
package keeps SpMM and GAT exact at every moment while letting layout
quality degrade only within priced bounds:

* :class:`DynamicPCSR` — batched edge insert/delete without a full
  re-pack (slack slots → delta chunks → tombstones; steering arrays
  only, the kernels are untouched);
* :class:`RepackGovernor` — prices the degraded layout against a fresh
  pack plus the amortised ``pack_setup_seconds`` and consults
  ``check_drift`` to decide do-nothing / re-select F / re-pack;
* :class:`DynamicGraph` — the operator surface: mutate, auto-heal, and
  keep calling ``spmm`` / ``gat`` (the CUDA kernels on the card);
* :func:`refresh_dist_graph` — the partitioned path: per-shard drift
  detection, each rank re-packing only its own shard if it changed.
"""
from .dist import ShardRefreshReport, refresh_dist_graph, shard_drift
from .governor import GovernorDecision, RepackGovernor
from .graph import DynamicGraph
from .pcsr import DynamicPCSR, MutationReport

__all__ = [
    "DynamicPCSR", "MutationReport",
    "RepackGovernor", "GovernorDecision",
    "DynamicGraph",
    "refresh_dist_graph", "shard_drift", "ShardRefreshReport",
]
