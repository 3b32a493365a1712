"""Seconds of the additive GAT pack's reorder: ``reorder_s``'s reading."""
from perfbench.metrics.reorder_s import read  # noqa: F401
