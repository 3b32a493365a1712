"""Selective scan (the Mamba recurrence): the CUDA kernels' wrappers
(forward, and backward for training) and their plain versions."""
from .ops import (CHUNK, launch_count, reset_launch_count, selective_scan,
                  selective_scan_backward)
from .ref import (selective_scan_backward_from_states_plain,
                  selective_scan_backward_plain,
                  selective_scan_chunk_states_plain, selective_scan_plain,
                  selective_scan_ref, selective_scan_states_plain)

__all__ = ["CHUNK", "launch_count", "reset_launch_count", "selective_scan",
           "selective_scan_backward",
           "selective_scan_backward_from_states_plain",
           "selective_scan_backward_plain",
           "selective_scan_chunk_states_plain", "selective_scan_plain",
           "selective_scan_ref", "selective_scan_states_plain"]
