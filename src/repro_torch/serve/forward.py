"""Bucketed GNN forwards, run eagerly.

``bucket_forward`` runs one bucket-padded batch: its aggregation closure
calls the kernel wrappers on the batch's steering with the bucket's
static geometry.  GCN/GIN: every layer's SpMM (with its fused epilogue)
is one ParamSpMM launch over ``geom.n_blocks`` chunk groups.  GAT
(single head, as the reference serves it): every layer's message is two
launches, the fused SDDMM → softmax-stats kernel and the ParamSpMM kernel
with its softmax prologue.  Layer semantics are literally
``models.gnn.gcn_forward`` / ``gin_forward`` / ``gat_forward``.

``reference_forward`` is the exactness oracle: the same model on the
*unpadded* subgraph through a fresh PCSR.  With integer-valued features,
weights and edge values the served GCN/GIN output is bit-equal to it
(padding slots add exact zeros; integer sums are order-free); GAT's
softmax normaliser is summed in layout order, so it matches to float
tolerance, not bits.
"""
from __future__ import annotations

from repro_torch.core.engine import gat_message_fn
from repro_torch.core.pcsr import build_pcsr
from repro_torch.kernels.paramspmm.ops import (Steering, _call,
                                               device_steering, paramspmm)
from repro_torch.models.gnn import gat_forward, gcn_forward, gin_forward

from .bucket import PackGeom

MODELS = ("gcn", "gin", "gat")
_SPMM_FORWARDS = {"gcn": gcn_forward, "gin": gin_forward}


def check_model(model: str) -> None:
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r} (one of {MODELS})")


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
    check_model(model)
    if model == "gat":
        return gat_forward(params, X, gat_message_fn(steer, geom))
    return _SPMM_FORWARDS[model](params, X, _bucket_spmm(steer, geom))


def reference_forward(csr, X, params, *, model: str, config):
    """The full-pipeline forward on an *unpadded* subgraph: a fresh PCSR
    under ``config`` (pass the serving pack's: GAT's softmax is
    layout-sensitive) and the same ``models.gnn`` forward, on ``X``'s
    device."""
    check_model(model)
    p = build_pcsr(csr.indptr, csr.indices, csr.data, csr.n_rows,
                   csr.n_cols, config)
    if model == "gat":
        return gat_forward(params, X,
                           gat_message_fn(device_steering(p, X.device), p))

    def fused(B, scale=None, bias=None, activation="none", residual=None):
        return paramspmm(p, B, scale=scale, bias=bias, residual=residual,
                         activation=activation)

    def spmm(B):
        return fused(B)

    spmm.fused = fused
    return _SPMM_FORWARDS[model](params, X, spmm)
