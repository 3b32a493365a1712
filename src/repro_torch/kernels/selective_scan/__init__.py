"""Selective scan (the Mamba recurrence): the CUDA kernel's wrapper and
its plain version."""
from .ops import launch_count, reset_launch_count, selective_scan
from .ref import selective_scan_plain

__all__ = ["launch_count", "reset_launch_count", "selective_scan",
           "selective_scan_plain"]
