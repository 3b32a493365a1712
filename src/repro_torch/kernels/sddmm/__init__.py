"""Fused SDDMM → edge-softmax stats: the CUDA kernel's wrapper, plain
version and oracle."""
