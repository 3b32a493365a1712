"""Device-idle ms an additive GAT step while the host was in
``gnn.forward``: ``forward_idle_ms``'s reading."""
from perfbench.metrics.forward_idle_ms import read  # noqa: F401
