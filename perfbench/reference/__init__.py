"""Plain PyTorch references of the configurations (no kernels of the
program, nothing of ``repro_torch`` or JAX imported)."""
