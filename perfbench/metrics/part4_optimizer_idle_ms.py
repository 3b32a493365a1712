"""Idle ms a partitioned GCN step on rank 0's card while its host was in
``gnn.optimizer``: ``optimizer_idle_ms``'s reading."""
from perfbench.metrics.optimizer_idle_ms import read  # noqa: F401
