"""Host-side formats and configuration selection of the PyTorch port: the
PCSR data structure, the configuration search (cost model, calibration,
features, decider) and the sparse containers.

Only numpy-level modules are imported here; the modules that reach the
kernels (``engine``, ``autotune``, ``baselines``) stay behind explicit
submodule imports.
"""
from .calibrate import (CalibrationResult, CalibrationSample, fit,
                        fit_columns, spearman)
from .cost_model import (H100, CostBreakdown, CostModel, Hardware,
                         degraded_kernel_cost, kernel_cost,
                         pack_setup_seconds, sddmm_cost, unfused_bytes,
                         unfused_penalty, useful_flops)
from .features import FEATURE_NAMES, MatrixFeatures, extract_features
from .pcsr import (LANES, PCSR, PCSRStats, SUBLANES, SpMMConfig,
                   balanced_capacity, build_pcsr, config_space, pad_pcsr,
                   pcsr_stats, pcsr_to_coo, slot_transfer_map,
                   transpose_csr, transpose_pcsr)
from .sparse import CSRMatrix

__all__ = [
    "CSRMatrix", "SpMMConfig", "config_space", "PCSR", "PCSRStats",
    "build_pcsr", "pad_pcsr", "pcsr_stats", "balanced_capacity",
    "pcsr_to_coo", "slot_transfer_map", "transpose_csr", "transpose_pcsr",
    "LANES", "SUBLANES", "Hardware", "H100", "CostBreakdown",
    "CostModel", "degraded_kernel_cost", "kernel_cost",
    "pack_setup_seconds", "sddmm_cost", "unfused_bytes",
    "unfused_penalty", "useful_flops",
    "CalibrationResult", "CalibrationSample", "fit", "fit_columns",
    "spearman",
    "FEATURE_NAMES", "MatrixFeatures", "extract_features",
]
