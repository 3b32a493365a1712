"""Idle ms a partitioned GCN step on rank 0's card while its host was in
``gnn.forward``: ``forward_idle_ms``'s reading."""
from perfbench.metrics.forward_idle_ms import read  # noqa: F401
