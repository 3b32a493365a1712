"""Bucketed GNN forwards: one program per (bucket geometry, model),
captured once as a CUDA graph on a card.

``bucket_forward`` runs one bucket-padded batch: its aggregation closure
calls the kernel wrappers on the batch's steering with the bucket's
static geometry.  GCN/GIN: every layer's SpMM (with its fused epilogue)
is one ParamSpMM launch over the geometry's fixed unit grid
(``PackGeom.bounds``).  GAT (single head, as the reference serves it):
every layer's message is two launches, the fused SDDMM → softmax-stats
kernel and the ParamSpMM kernel with its softmax prologue.  Layer
semantics are literally ``models.gnn.gcn_forward`` / ``gin_forward`` /
``gat_forward``.

``BucketProgram`` is the reference's one ``jax.jit`` per bucket
(``repro/serve/forward.py``): static device buffers for the steering and
the padded features, filled per batch, and on a card the forward
captured once as a CUDA graph and replayed for every later batch.
``serve_recompiles_total`` counts one per program, as the reference
counts one per trace: at the capture on a card, at the first forward
where nothing is captured (the CPU, or ``graphs=False``).

``reference_forward`` is the exactness oracle: the same model on the
*unpadded* subgraph through a fresh PCSR.  With integer-valued features,
weights and edge values the served GCN/GIN output is bit-equal to it
(padding slots add exact zeros; integer sums are order-free); GAT's
softmax normaliser is summed in layout order, so it matches to float
tolerance, not bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import gat_message_fn
from repro_torch.core.pcsr import PCSR, build_pcsr
from repro_torch.kernels.capture import capture
from repro_torch.kernels.paramspmm.ops import (Steering, _call,
                                               device_steering,
                                               host_steering, paramspmm)
from repro_torch.models.gnn import gat_forward, gcn_forward, gin_forward
from repro_torch.obs import metrics as _metrics

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


# the steering's arrays a program refills per batch
_ARRAYS = ("colidx", "lrow", "trow", "vals", "groups", "units", "splits")


class _Staged:
    """A device tensor refilled from host arrays: on a card through a
    pinned host copy and a non-blocking copy, on the CPU in place."""

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self.host = (torch.empty_like(dev, device="cpu").pin_memory()
                     if dev.is_cuda else dev)

    def push(self) -> None:
        """Copy the host buffer to the device (after writing it)."""
        if self.host is not self.dev:
            self.dev.copy_(self.host, non_blocking=True)

    def load(self, arr: np.ndarray) -> None:
        self.host.numpy()[...] = arr
        self.push()


class BucketProgram:
    """The forward of one (bucket geometry, model) on one device, over
    buffers whose addresses stay fixed: the steering at the geometry's
    schedule bounds and the ``(geom.n_rows, f)`` padded features.

    Each call copies the batch's steering and features into those buffers
    (host arrays through pinned memory, non-blocking) and returns the
    forward's ``(geom.n_rows, out)`` output.  On a card with ``graphs``
    the first call runs the forward eagerly on a side stream (the
    warm-up) and its output is that batch's; then the forward is captured
    into a CUDA graph in ``pool``, and every later call replays it.  The
    output of a replay is the graph's static output: read it before the
    next replay of any graph in the pool.  A failed capture or replay
    raises."""

    def __init__(self, geom: PackGeom, first: PCSR, params, n_feat: int,
                 device, *, model: str, graphs: bool, pool=None):
        check_model(model)
        self.geom, self.model, self.params = geom, model, params
        self.device = torch.device(device)
        if graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{self.device}")
        self.graphs, self.pool = graphs, pool
        self.bounds = geom.bounds()
        # the buffers own their memory (a CPU tensor from numpy shares it)
        s0 = Steering.from_pcsr(first, self.device, bounds=self.bounds)
        self.steer = dataclasses.replace(s0, **{
            k: getattr(s0, k).clone() for k in _ARRAYS})
        self._arrays = {k: _Staged(getattr(self.steer, k)) for k in _ARRAYS}
        self._X = _Staged(torch.zeros((geom.n_rows, n_feat),
                                      dtype=torch.float32,
                                      device=self.device))
        self._copied = (torch.cuda.Event() if self.device.type == "cuda"
                        else None)
        self.captured = None
        _metrics.counter("serve_recompiles_total").inc(
            model=model, backend=self.device.type,
            bucket=f"r{geom.n_rows}c{geom.num_chunks}")

    def _forward(self):
        return bucket_forward(self.steer, self._X.dev, self.params,
                              geom=self.geom, model=self.model)

    def load(self, padded: PCSR, X: np.ndarray) -> None:
        """Copy a batch's bucket-padded PCSR and ``(n, f)`` features
        (``n ≤ geom.n_rows``; the rest are padding rows, zeroed) into
        the program's buffers."""
        if self._copied is not None:
            self._copied.synchronize()   # the last batch's copies are done
        h = host_steering(padded, bounds=self.bounds)
        if h["n_cols"] != self.steer.n_cols:
            raise ValueError(f"batch n_cols {h['n_cols']} is not the "
                             f"bucket's {self.steer.n_cols}")
        for k, staged in self._arrays.items():
            if h[k].shape != tuple(staged.dev.shape):
                raise ValueError(f"batch {k} {h[k].shape} is not the "
                                 f"bucket's {tuple(staged.dev.shape)}")
            staged.load(h[k])
        host = self._X.host.numpy()
        host[:len(X)] = X
        host[len(X):] = 0.0
        self._X.push()
        if self._copied is not None:
            self._copied.record()

    def __call__(self, padded: PCSR, X: np.ndarray) -> torch.Tensor:
        """The forward on one batch (``load``, then run or replay)."""
        self.load(padded, X)
        with torch.no_grad():
            if not self.graphs:
                return self._forward()
            if self.captured is None:
                first, self.captured = capture(self._forward, self.device,
                                               pool=self.pool)
                return first
            return self.captured.replay()


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
