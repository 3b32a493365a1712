"""Seconds of the additive GAT's pack and config pick: ``pack_s``'s
reading."""
from perfbench.metrics.pack_s import read  # noqa: F401
