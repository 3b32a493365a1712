"""Bucketed GNN forwards, run eagerly.

``bucket_forward`` runs one bucket-padded batch: its aggregation closure
calls the ParamSpMM wrapper on the batch's steering with the bucket's
static geometry, so every layer's SpMM (with its fused epilogue) is one
kernel launch over ``geom.n_blocks`` chunk groups.  Layer semantics are
literally ``models.gnn.gcn_forward`` / ``gin_forward``.

``reference_forward`` is the exactness oracle: the same model on the
*unpadded* subgraph through a fresh PCSR.  With integer-valued features,
weights and edge values the served GCN/GIN output is bit-equal to it
(padding slots add exact zeros; integer sums are order-free).
"""
from __future__ import annotations

from repro_torch.core.pcsr import build_pcsr
from repro_torch.kernels.paramspmm.ops import Steering, _call, paramspmm
from repro_torch.models.gnn import gcn_forward, gin_forward

from .bucket import PackGeom

_FORWARDS = {"gcn": gcn_forward, "gin": gin_forward}


def _model_forward(model: str):
    if model == "gat":
        raise NotImplementedError(
            "GAT serving needs the SDDMM→softmax kernel and the SpMM "
            "prologue (next slice of the port, ROADMAP Queue 1)")
    if model not in _FORWARDS:
        raise ValueError(f"unknown model {model!r}")
    return _FORWARDS[model]


def _bucket_spmm(steer: Steering, geom: PackGeom):
    """``spmm(B)`` + ``.fused(...)`` closures over a batch's steering with
    the bucket's static geometry."""
    cfg = geom.config

    def fused(B, scale=None, bias=None, activation="none", residual=None):
        return _call(steer, B, n_blocks=geom.n_blocks, R=cfg.R, V=cfg.V,
                     K=geom.K, dblk=cfg.dblk, n_rows=geom.n_rows,
                     scale=scale, bias=bias, residual=residual,
                     activation=activation)

    def spmm(B):
        return fused(B)

    spmm.fused = fused
    return spmm


def bucket_forward(steer: Steering, X, params, *, geom: PackGeom,
                   model: str):
    """Full GNN forward on one bucket-padded batch: ``X`` is the
    ``(geom.n_rows, f)`` padded feature matrix on the steering's device.
    Rows past the real batch are padding and are sliced off by the
    caller."""
    return _model_forward(model)(params, X, _bucket_spmm(steer, geom))


def reference_forward(csr, X, params, *, model: str, config):
    """The full-pipeline forward on an *unpadded* subgraph: a fresh PCSR
    under ``config`` and the same ``models.gnn`` forward, on ``X``'s
    device."""
    fwd = _model_forward(model)
    p = build_pcsr(csr.indptr, csr.indices, csr.data, csr.n_rows,
                   csr.n_cols, config)

    def fused(B, scale=None, bias=None, activation="none", residual=None):
        return paramspmm(p, B, scale=scale, bias=bias, residual=residual,
                         activation=activation)

    def spmm(B):
        return fused(B)

    spmm.fused = fused
    return fwd(params, X, spmm)
