"""Seconds of the additive GAT's transpose side, in step 0's backward:
``transpose_side_s``'s reading."""
from perfbench.metrics.transpose_side_s import read  # noqa: F401
