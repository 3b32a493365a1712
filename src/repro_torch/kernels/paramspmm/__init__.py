"""ParamSpMM: the CUDA kernel's wrapper, plain version and oracle."""
from .ops import paramspmm, paramspmm_with_vals
from .ref import spmm_dense_ref, spmm_ref

__all__ = ["paramspmm", "paramspmm_with_vals", "spmm_dense_ref", "spmm_ref"]
