"""ParamSpMM: the CUDA kernel's wrapper, plain version and oracle."""
