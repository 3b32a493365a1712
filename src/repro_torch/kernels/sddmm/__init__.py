"""SDDMM: the fused SDDMM → edge-softmax stats kernel and the raw SDDMM
kernel — their wrappers, plain versions and oracles."""
from .ops import (normalize_from_stats, sddmm, sddmm_softmax,
                  sddmm_softmax_stats)
from .ref import sddmm_dense_ref, sddmm_slots_ref

__all__ = ["normalize_from_stats", "sddmm", "sddmm_softmax",
           "sddmm_softmax_stats", "sddmm_dense_ref", "sddmm_slots_ref"]
