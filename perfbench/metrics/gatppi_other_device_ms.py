"""Device ms an additive GAT step outside the three kernel families (the
GEMMs of ``gatppi_gemm_ms`` among them): ``other_device_ms``'s reading."""
from perfbench.metrics.other_device_ms import read  # noqa: F401
