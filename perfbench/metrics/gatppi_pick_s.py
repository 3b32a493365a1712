"""Seconds of the additive GAT pack's config pick: ``pick_s``'s reading."""
from perfbench.metrics.pick_s import read  # noqa: F401
