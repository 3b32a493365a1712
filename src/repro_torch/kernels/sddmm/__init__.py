"""SDDMM: the fused SDDMM → edge-softmax stats kernel and the raw SDDMM
kernel — their wrappers, plain versions and oracles."""
