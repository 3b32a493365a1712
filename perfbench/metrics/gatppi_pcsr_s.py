"""Seconds of the additive GAT pack's PCSRs of A and Aᵀ: ``pcsr_s``'s
reading."""
from perfbench.metrics.pcsr_s import read  # noqa: F401
