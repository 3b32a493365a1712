"""ParamSpMM computing engine (paper Alg. 2) in plain PyTorch, forward only.

The same PCSR traversal as the CUDA kernels, expressed as gather +
``index_add_``: the kernels' plain versions (``kernels.paramspmm.ops.
paramspmm_plain`` is this engine plus ``apply_epilogue``) and the
semantics every backend is held to.  ``_engine_sddmm`` / ``edge_softmax``
/ ``attend_scores`` are the attention step's plain semantics;
``make_gat_message_fn`` is the two-kernel GAT message (fused SDDMM →
softmax stats, then the ParamSpMM softmax prologue).  The differentiable
operators come with the training slice of the port.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .pcsr import PCSR


def _engine(colidx, lrow, trow, vals, B, *, V, R, K, n_blocks, n_rows):
    """Scatter-add evaluation of the packed PCSR chunks."""
    ck = colidx.shape[0]
    gathered = B.index_select(0, colidx)                      # (C·K, dim)
    base = trow.repeat_interleave(K) * R + lrow * V
    valsf = vals.transpose(1, 2).reshape(ck, V).to(B.dtype)
    out = B.new_zeros((n_blocks * R, B.shape[1]))
    for v in range(V):                                        # V ≤ 2
        out.index_add_(0, base + v, valsf[:, v, None] * gathered)
    return out[:n_rows]


def engine_spmm(pcsr: PCSR, B: torch.Tensor) -> torch.Tensor:
    """C = A·B on the plain engine, on ``B``'s device."""
    st = pcsr.steering()
    arrs = {k: torch.as_tensor(st[k], device=B.device)
            for k in ("colidx", "lrow", "trow", "vals")}
    cfg = pcsr.config
    return _engine(arrs["colidx"], arrs["lrow"], arrs["trow"], arrs["vals"],
                   B, V=cfg.V, R=cfg.R, K=pcsr.K, n_blocks=pcsr.n_blocks,
                   n_rows=pcsr.n_rows)


def _engine_sddmm(colidx, lrow, trow, vals, Q, K_mat, *, V, R, K):
    """Gather/dot evaluation of per-slot SDDMM scores ``(C, V, K)``;
    masked slots (``vals == 0``) score 0."""
    C = colidx.shape[0] // K
    gathered = K_mat.index_select(0, colidx)                  # (C·K, d)
    base = trow.repeat_interleave(K) * R + lrow * V
    scores = []
    for v in range(V):                                        # V ≤ 2
        # rows past the end of Q (block padding) read as zero → score 0
        row = base + v
        inside = row < Q.shape[0]
        qrow = Q.index_select(0, torch.where(inside, row, 0))
        qrow = torch.where(inside[:, None], qrow, 0.0)
        scores.append((qrow * gathered).sum(dim=1))
    e = torch.stack(scores, dim=1).reshape(C, K, V).transpose(1, 2)
    return torch.where(vals != 0, e, 0.0)


def engine_sddmm(pcsr: PCSR, Q: torch.Tensor,
                 K_mat: torch.Tensor) -> torch.Tensor:
    """E = (A≠0) ⊙ (Q·Kᵀ) in PCSR slot layout, on ``Q``'s device."""
    st = pcsr.steering()
    arrs = {k: torch.as_tensor(st[k], device=Q.device)
            for k in ("colidx", "lrow", "trow", "vals")}
    cfg = pcsr.config
    return _engine_sddmm(arrs["colidx"], arrs["lrow"], arrs["trow"],
                         arrs["vals"], Q, K_mat, V=cfg.V, R=cfg.R, K=pcsr.K)


def _slot_rows(lrow, trow, *, V, R, K):
    """Destination row of every slot, in ``(C, V, K)`` layout (int64)."""
    C = trow.shape[0]
    base = (trow.long()[:, None, None] * R
            + lrow.long().reshape(C, 1, K) * V)
    return base + torch.arange(V, device=trow.device)[None, :, None]


def normalize_from_stats(logits, rowmax, rowsum, lrow, trow, *, R, V, K):
    """α = exp(logit − rowmax[row]) / rowsum[row] per slot — the one
    α-from-stats implementation (the plain prologue and ``sddmm_softmax``
    both run it).  ``logits`` are ``(..., C, V, K)`` and the stats
    ``(..., n_blocks·R)`` with the same leading axes.

    The guards are NaN-proof: ``isfinite`` rejects NaN and ±inf and
    ``rowsum > 0`` is False for NaN, so a row without a real edge (or
    with garbage stats) normalises against (0, 1), and its −inf logits
    come out exactly α = 0."""
    rows = _slot_rows(lrow, trow, V=V, R=R, K=K)
    rm = torch.where(torch.isfinite(rowmax), rowmax, 0.0)
    den = torch.where((rowsum > 0) & torch.isfinite(rowsum), rowsum, 1.0)
    return torch.exp(logits - rm[..., rows]) / den[..., rows]


def edge_softmax(scores, mask, rows, n_segments: int):
    """Numerically stable softmax over each destination row's edge set.

    ``scores``/``mask``/``rows`` are all ``(C, V, K)``; padding slots
    (mask False) get weight 0 and never reach their row's max or
    normaliser."""
    flat = rows.reshape(-1)
    neg = torch.where(mask, scores, -torch.inf).reshape(-1)
    rowmax = torch.full((n_segments,), -torch.inf, dtype=scores.dtype,
                        device=scores.device)
    rowmax = rowmax.scatter_reduce(0, flat, neg, "amax")
    rowmax = torch.where(torch.isfinite(rowmax), rowmax, 0.0)  # empty rows
    ex = torch.exp(neg - rowmax[flat])
    ex = torch.where(mask.reshape(-1), ex, 0.0)
    denom = torch.zeros(n_segments, dtype=scores.dtype,
                        device=scores.device).index_add_(0, flat, ex)
    alpha = ex / torch.clamp_min(denom[flat], 1e-30)
    return alpha.reshape(scores.shape)


def attend_scores(scores, mask, rows, n_segments: int, *, dim_k: int,
                  slope: float = 0.2):
    """The GAT attention step in plain form: raw SDDMM scores divided by
    √d_k, LeakyReLU(slope), softmax over each destination row's edges."""
    scaled = scores / torch.sqrt(torch.tensor(float(dim_k),
                                              dtype=scores.dtype))
    scaled = torch.where(scaled >= 0, scaled, slope * scaled)
    return edge_softmax(scaled, mask, rows, n_segments)


def gat_message(steer, Q, K_mat, Vf, *, n_blocks, R, V, K, dblk, n_rows,
                slope: float = 0.2):
    """The GAT message over one covered steering: the fused SDDMM →
    softmax-stats kernel, then the ParamSpMM kernel with its softmax
    prologue — two launches on CUDA tensors, their plain versions on CPU
    tensors, α never materialised.  ``(n, d)`` operands return
    ``(n_rows, dv)``; ``(H, n, d)`` ones run every head in the same two
    launches and return ``(H, n_rows, dv)``.  Forward only: raises if an
    input requires grad (the backward comes with the training slice)."""
    from repro_torch.kernels.paramspmm import ops as spmm_ops
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    if any(t.requires_grad for t in (Q, K_mat, Vf)):
        raise NotImplementedError(
            "the GAT message has no backward yet (training slice, ROADMAP "
            "Queue 1 item 2): call it under torch.no_grad()")
    logits, rowmax, rowsum = sddmm_ops._call(
        steer, Q, K_mat, n_blocks=n_blocks, R=R, V=V, K=K, n_rows=n_rows,
        scale=float(1.0 / np.sqrt(Q.shape[-1])), slope=slope)
    return spmm_ops._call(steer, Vf, vals=logits, rowmax=rowmax,
                          rowsum=rowsum, n_blocks=n_blocks, R=R, V=V, K=K,
                          dblk=dblk, n_rows=n_rows)


def gat_message_fn(steer, geo, *, slope: float = 0.2):
    """``f(Q, K, Vf)``: ``gat_message`` over ``steer`` with the geometry
    of ``geo`` — a ``PCSR`` or a serving bucket's ``PackGeom``, both of
    which carry ``config``, ``n_blocks``, ``n_rows`` and ``K``."""
    cfg = geo.config
    return functools.partial(gat_message, steer, n_blocks=geo.n_blocks,
                             R=cfg.R, V=cfg.V, K=geo.K, dblk=cfg.dblk,
                             n_rows=geo.n_rows, slope=slope)


def make_gat_message_fn(pcsr: PCSR, *, slope: float = 0.2):
    """GAT message ``f(Q, K, Vf)`` over one PCSR: SDDMM → scale 1/√d →
    LeakyReLU(slope) → edge softmax → SpMM, as two kernel launches
    (``gat_message``) on the inputs' device."""
    from repro_torch.kernels.paramspmm.ops import device_steering

    def f(Q, K_mat, Vf):
        steer = device_steering(pcsr, Q.device)
        return gat_message_fn(steer, pcsr, slope=slope)(Q, K_mat, Vf)
    return f


def apply_epilogue(out, scale=None, bias=None, activation: str = "none",
                   slope: float = 0.2, residual=None):
    """The SpMM epilogue semantics:
    ``act(scale[:, None] ⊙ out + bias[None, :] + residual)`` — what the
    CUDA kernel's fused epilogue computes on each finished output tile."""
    if scale is not None:
        out = out * scale[:, None]
    if bias is not None:
        out = out + bias[None, :]
    if residual is not None:
        out = out + residual
    if activation == "relu":
        out = torch.relu(out)
    elif activation == "leaky_relu":
        out = torch.where(out >= 0, out, slope * out)
    elif activation != "none":
        raise ValueError(f"unknown epilogue activation {activation!r}")
    return out
