"""Wrappers of the port's CUDA kernels (sources in ``repro_torch/csrc``)."""
