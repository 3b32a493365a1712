"""95th percentile of rank 0's window step times before CUPTI started in
the partitioned GCN: ``step_p95_ms``'s reading."""
from perfbench.metrics.step_p95_ms import read  # noqa: F401
