"""SpMM baselines the paper compares against (§6.1), on the card:

  * cuSPARSE  → ``torch.sparse.mm`` of a CSR ``torch.sparse_csr_tensor``
    by dense B: cuSPARSE's SpMM on CUDA, the paper's own baseline
    (the input-agnostic library kernel);
  * GE-SpMM   → static row-wise CSR: gather + ``index_add_`` (no
    blocking, no balancing), as the reference's ``spmm_ref``;
  * GNNAdvisor → heuristic runtime: always-on balancing, no blocking,
    dim-scaled coarsening ("simply increase F with dim"), run on the
    port's own ParamSpMM operator at that config;
  * DA-SpMM   → ML-adaptive over a reduced space (no blocking, no
    coarsening: the paper notes their space overlooks V and F).

The cuSPARSE and GE-SpMM analogues are differentiable in B, so
``apps/gnn.py`` trains through them (``--spmm cusparse|gespmm``).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .pcsr import LANES, SpMMConfig
from .sparse import CSRMatrix


def _csr_tensor(csr: CSRMatrix, device) -> torch.Tensor:
    with warnings.catch_warnings():              # "CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(np.asarray(csr.indptr, np.int64), device=device),
            torch.as_tensor(np.asarray(csr.indices, np.int64),
                            device=device),
            torch.as_tensor(np.asarray(csr.data, np.float32), device=device),
            size=csr.shape)


class _CSRMatMul(torch.autograd.Function):
    """C = A·B with A a constant CSR tensor: one library SpMM forward,
    and one on Aᵀ (a second CSR tensor, built once) backward."""

    @staticmethod
    def forward(ctx, B, A, At):
        ctx.At = At
        return torch.sparse.mm(A, B)

    @staticmethod
    def backward(ctx, dC):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return torch.sparse.mm(ctx.At, dC.contiguous()), None, None


# ---------------------------------------------------------------- cuSPARSE
def make_cusparse_analog(csr: CSRMatrix, device=None):
    """``fn(B) = A·B`` through ``torch.sparse.mm`` on a CSR tensor on
    ``device`` (default CUDA; raises without a card)."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    A = _csr_tensor(csr, device)
    At = _csr_tensor(csr.transpose(), device)

    def fn(B):
        return _CSRMatMul.apply(B, A, At)
    return fn


# ----------------------------------------------------------------- GE-SpMM
def make_gespmm_analog(csr: CSRMatrix, device=None):
    """``fn(B) = A·B`` row-wise over CSR: ``spmm_ref``'s gather +
    ``index_add_``, with the row and column indices staged on ``device``
    (default CUDA) once.  Autograd differentiates it in B."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    rows = torch.as_tensor(np.repeat(np.arange(csr.n_rows), csr.degrees),
                           dtype=torch.int64, device=device)
    cols = torch.as_tensor(np.asarray(csr.indices), dtype=torch.int64,
                           device=device)
    vals = torch.as_tensor(np.asarray(csr.data, np.float32), device=device)
    n = csr.n_rows

    def fn(B):
        contrib = vals[:, None] * B.index_select(0, cols)
        return B.new_zeros((n, B.shape[1])).index_add_(0, rows, contrib)
    return fn


# -------------------------------------------------------------- GNNAdvisor
def gnnadvisor_config(dim: int) -> SpMMConfig:
    f = max(1, -(-dim // LANES))           # F grows with dim, gap ignored
    return SpMMConfig(V=1, S=True, F=min(f, 4), W=8)


def make_gnnadvisor_analog(csr: CSRMatrix, dim: int, device=None):
    """The port's ParamSpMM operator at ``gnnadvisor_config(dim)``;
    returns ``(operator, config)``."""
    from repro_torch.device import resolve_device

    from .engine import ParamSpMMOperator
    cfg = gnnadvisor_config(dim)
    return ParamSpMMOperator(csr, cfg, device=resolve_device(device)), cfg


# ---------------------------------------------------------------- DA-SpMM
def daspmm_space(dim: int):
    """DA-SpMM's adaptivity without blocking (V) or coarsening (F)."""
    return [SpMMConfig(V=1, S=s, F=1, W=r) for s in (False, True)
            for r in (8, 16, 32)]
