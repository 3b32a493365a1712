"""Host-side formats and configuration selection of the PyTorch port."""
from .cost_model import (H100, CostBreakdown, CostModel, Hardware,
                         kernel_cost, sddmm_cost)
from .pcsr import (LANES, PCSR, PCSRStats, SUBLANES, SpMMConfig,
                   balanced_capacity, build_pcsr, config_space, pad_pcsr,
                   pcsr_stats)
from .sparse import CSRMatrix

__all__ = [
    "CSRMatrix", "SpMMConfig", "config_space", "PCSR", "PCSRStats",
    "build_pcsr", "pad_pcsr", "pcsr_stats", "balanced_capacity",
    "LANES", "SUBLANES", "Hardware", "H100", "CostBreakdown",
    "CostModel", "kernel_cost", "sddmm_cost",
]
