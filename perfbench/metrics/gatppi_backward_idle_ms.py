"""Device-idle ms an additive GAT step while the host was in
``gnn.backward``: ``backward_idle_ms``'s reading."""
from perfbench.metrics.backward_idle_ms import read  # noqa: F401
