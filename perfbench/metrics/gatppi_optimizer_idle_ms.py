"""Device-idle ms an additive GAT step while the host was in
``gnn.optimizer``: ``optimizer_idle_ms``'s reading."""
from perfbench.metrics.optimizer_idle_ms import read  # noqa: F401
