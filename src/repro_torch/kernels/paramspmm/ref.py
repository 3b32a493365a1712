"""Plain row-wise CSR SpMM (paper Alg. 1): the correctness oracle for the
PCSR paths, as a gather + ``index_add_``."""
from __future__ import annotations

import numpy as np
import torch


def spmm_ref(indptr, indices, data, B: torch.Tensor, n_rows: int):
    """C[n_rows, dim] = A · B with A given as host CSR arrays."""
    indptr = np.asarray(indptr)
    rows = torch.as_tensor(np.repeat(np.arange(n_rows), np.diff(indptr)),
                           dtype=torch.int64, device=B.device)
    cols = torch.as_tensor(np.asarray(indices), dtype=torch.int64,
                           device=B.device)
    vals = torch.as_tensor(np.asarray(data), device=B.device).to(B.dtype)
    contrib = vals[:, None] * B.index_select(0, cols)     # (nnz, dim)
    out = B.new_zeros((n_rows, B.shape[1]))
    return out.index_add_(0, rows, contrib)


def spmm_dense_ref(A_dense, B: torch.Tensor) -> torch.Tensor:
    """Dense oracle for small property tests: ``A·B``."""
    return torch.as_tensor(A_dense).to(B.dtype) @ B
