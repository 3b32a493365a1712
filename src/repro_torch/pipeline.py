"""The ParamSpMM three-phase workflow (paper Fig. 2): configuration
prediction (``pick_config``) → PCSR generation (``core.pcsr.build_pcsr``,
for A and Aᵀ) → computing engine (``core.engine.ParamSpMMOperator``, the
CUDA kernels).  ``ParamSpMM`` runs all three for one matrix, after the
locality reorder of paper §4.4.  Spans (``repro_torch.obs``):
``pack.reorder`` (the reorder and its two padding-ratio passes),
``pack.pick`` (``pick_config``, absent when a config is given) and
``pack.pcsr`` (the PCSRs of A and Aᵀ, in ``ParamSpMMOperator``)."""
from __future__ import annotations

import numpy as np

from .core import (CostModel, CSRMatrix, H100, Hardware, SpMMConfig,
                   config_space, extract_features, pcsr_stats)
from .core.engine import ParamSpMMOperator
from .core.reorder import apply_reorder, rabbit_reorder
from .obs.trace import span


def pick_config(csr: CSRMatrix, dim: int, *, decider=None,
                select: str = "model", op: str = "spmm", heads: int = 1,
                hardware: Hardware = H100, device=None) -> SpMMConfig:
    """Configuration pick shared by every entry point.  The order is the
    JAX package's: the ``decider``'s prediction (a ``core.decider.
    SpMMDecider``) > the measured oracle (``select="measured"``: every
    config of ``config_space(dim)`` timed on ``device``, default CUDA,
    two reps) > a cost-model sweep over ``config_space(dim)`` priced for
    ``hardware``.  The serving tier calls it once per shape bucket.
    """
    if decider is not None:
        return decider.predict(extract_features(csr), dim)
    if select == "measured":
        from .core.autotune import oracle_search
        return oracle_search(csr, dim, mode="measured", reps=2, op=op,
                             H=heads, device=device).best_config
    if select != "model":
        raise ValueError(f"unknown select {select!r}")
    config, _ = CostModel(csr, hardware).best(dim, config_space(dim),
                                              op=op, H=heads)
    return config


def _pr2(csr: CSRMatrix) -> float:
    """V=2 padding ratio: the locality metric the reorder minimises."""
    return pcsr_stats(csr.indptr, csr.indices, csr.n_rows, csr.n_cols,
                      2, 4).padding_ratio


class ParamSpMM:
    """End-to-end adaptive SpMM for one sparse matrix and embedding dim.

    ``reorder`` (default) relabels the nodes with ``rabbit_reorder`` and
    keeps whichever ordering, old or new, has the lower V=2 padding ratio
    (reordering an already well-ordered graph can only hurt); ``perm``
    (node i → ``perm[i]``) says how to permute node-aligned data.  The
    config is ``config`` if given, else ``pick_config`` for ``op``
    ("spmm", "sddmm" or "gat") and ``heads``: the ``decider``'s, the
    measured oracle's on ``device`` (``select="measured"``) or the cost
    model's on ``hardware``.  ``p(B)`` is
    the differentiable SpMM, ``p.fused(B, scale=, bias=, activation=,
    residual=)`` the epilogue-fused one; ``p.op`` holds the PCSRs of A and
    Aᵀ.  ``device`` (default CUDA; raises without a card) is where the
    steering is staged.
    """

    def __init__(self, csr: CSRMatrix, dim: int, *,
                 config: SpMMConfig | None = None, decider=None,
                 reorder: bool = True, build_transpose: bool = True,
                 select: str = "model", op: str = "spmm", heads: int = 1,
                 hardware: Hardware = H100, device=None):
        from .device import resolve_device
        device = resolve_device(device)
        self.perm = None
        if reorder:
            with span("pack.reorder"):
                perm = rabbit_reorder(csr)
                cand = apply_reorder(csr, perm)
                if _pr2(cand) <= _pr2(csr):
                    self.perm = perm
                    csr = cand
                else:
                    self.perm = np.arange(csr.n_rows)
        self.csr = csr
        self.dim = dim
        if config is None:
            with span("pack.pick"):
                config = pick_config(csr, dim, decider=decider,
                                     select=select, op=op, heads=heads,
                                     hardware=hardware, device=device)
        self.config = config
        self.op = ParamSpMMOperator(csr, config,
                                    build_transpose=build_transpose,
                                    device=device)

    def __call__(self, B):
        return self.op(B)

    def fused(self, B, scale=None, bias=None, activation: str = "none",
              residual=None):
        """Epilogue-fused aggregation:
        act(scale ⊙ (A·B) + bias + residual)."""
        return self.op.fused(B, scale=scale, bias=bias,
                             activation=activation, residual=residual)
