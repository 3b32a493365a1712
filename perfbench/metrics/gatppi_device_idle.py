"""Share of an additive GAT step, in %, in which no device op ran:
``device_idle``'s reading."""
from perfbench.metrics.device_idle import read  # noqa: F401
