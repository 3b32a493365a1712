"""Device ms a partitioned GCN step on rank 0's card outside the kernel
families, NCCL's kernels (``part4_collective_ms``) among them:
``other_device_ms``'s reading."""
from perfbench.metrics.other_device_ms import read  # noqa: F401
