"""Idle ms a partitioned GCN step on rank 0's card while its host was in
``gnn.backward`` (the gradient all-reduce's wait in it):
``backward_idle_ms``'s reading."""
from perfbench.metrics.backward_idle_ms import read  # noqa: F401
