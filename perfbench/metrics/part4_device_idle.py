"""Share of a partitioned GCN step, in %, in which rank 0's card ran no
op: ``device_idle``'s reading."""
from perfbench.metrics.device_idle import read  # noqa: F401
