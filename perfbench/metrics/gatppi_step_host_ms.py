"""Host ms to issue an additive GAT step: ``step_host_ms``'s reading."""
from perfbench.metrics.step_host_ms import read  # noqa: F401
