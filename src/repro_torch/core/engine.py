"""ParamSpMM computing engine (paper Alg. 2) and its differentiable
operators.

``_engine`` / ``engine_spmm`` are the PCSR traversal as gather +
``index_add_``: the kernels' plain versions (``kernels.paramspmm.ops.
paramspmm_plain`` is this engine plus ``apply_epilogue``) and the
semantics every backend is held to.  ``_engine_sddmm`` / ``edge_softmax``
/ ``attend_scores`` are the attention step's plain semantics.

The operators GNN training runs are ``torch.autograd.Function``s whose
forward and backward are kernel launches (their plain versions on CPU
tensors), as the paper's PyTorch extension runs forward and backward
SpMM:

* ``make_spmm_fn(pcsr, pcsr_t)``: ``C = A·B``, backward ``dB =
  SpMM(pcsrᵀ, dC)`` on the transpose PCSR;
* ``make_fused_spmm_fn(pcsr, pcsr_t)``: ``act(scale ⊙ (A·B) + bias +
  residual)`` in one launch, backward ``dpre = dOut ⊙ act'(out)``,
  ``dbias = Σ_rows dpre``, ``dresidual = dpre``, ``dB = SpMM(pcsrᵀ,
  scale ⊙ dpre)`` (``scale`` is graph data, a constant);
* ``make_gat_message_fn(pcsr, pcsr_t)``: the two-kernel GAT message
  (fused SDDMM → softmax stats, then the ParamSpMM softmax prologue) with
  the flash-recompute backward of ``gat_message``.

Each backward skips the launches whose gradient no input needs
(``ctx.needs_input_grad``).  ``ParamSpMMOperator`` holds the forward and
transpose PCSR of one matrix and both SpMM operators.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.obs.trace import span

from .pcsr import PCSR, SpMMConfig, build_pcsr, slot_transfer_map, \
    transpose_pcsr
from .sparse import CSRMatrix


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


@dataclass(frozen=True)
class TransposeSide:
    """What the GAT backward needs beyond A's steering, on one device:
    the covered steering and geometry of Aᵀ's PCSR (``pcsr_t``) and the
    slot map ``src`` onto it: for each of Aᵀ's covered slots, A's covered
    flat slot holding the same edge, or −1 where the slot holds none (the
    covered layouts begin with the uncovered ones ``slot_transfer_map``
    indexes)."""

    steer: object               # kernels.paramspmm.ops.Steering of Aᵀ
    geo: dict                   # n_blocks, R, V, K, dblk, n_rows of Aᵀ
    shape: tuple                # covered slot shape (C_t, V, K_t)
    src: torch.Tensor           # (C_t·V·K_t,) int32 into A's slots, or −1

    @staticmethod
    def build(pcsr: PCSR, pcsr_t: PCSR, device) -> "TransposeSide":
        """Aᵀ's side on ``device``, under the span ``gat.transpose_side``."""
        from repro_torch.kernels.paramspmm.ops import device_steering
        with span("gat.transpose_side"):
            f_idx, t_idx = slot_transfer_map(pcsr, pcsr_t)
            cfg = pcsr_t.config
            shape = (pcsr_t.covered_num_chunks, cfg.V, pcsr_t.K)
            src = np.full(int(np.prod(shape)), -1, dtype=np.int32)
            src[t_idx] = f_idx
            return TransposeSide(
                steer=device_steering(pcsr_t, device),
                geo=dict(n_blocks=pcsr_t.n_blocks, R=cfg.R, V=cfg.V,
                         K=pcsr_t.K, dblk=cfg.dblk, n_rows=pcsr_t.n_rows),
                shape=shape, src=torch.as_tensor(src, device=device))


def _row_dot(dOut, out, n_segments: int):
    """Σ_j α_ij·dα_ij for each destination row i, taken as dOut_i · out_i
    (dα_ij = dOut_i · Vf_j and out_i = Σ_j α_ij Vf_j): a product with the
    forward's output, no scatter.  ``dOut`` and ``out`` are ``(...,
    n_rows, dv)``; returns ``(..., n_segments)``, rows past ``n_rows``
    (padding) 0.  With no atomic in the sum, two calls give the same
    bits."""
    d = (dOut * out).sum(-1)
    return torch.nn.functional.pad(d, (0, n_segments - d.shape[-1]))


def _pad_rows(x, n: int):
    """``x`` with zero rows appended (second-to-last axis) up to ``n``."""
    extra = n - x.shape[-2]
    if extra <= 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-2] + (extra, x.shape[-1]))],
                     dim=-2)


@dataclass(frozen=True)
class _GATSpec:
    steer: object                       # A's covered Steering
    geo: dict                           # n_blocks, R, V, K, dblk, n_rows
    slope: float
    transpose: Optional[Callable]       # device → TransposeSide, or None


class _GATMessage(torch.autograd.Function):
    """The GAT message over one covered steering, forward and backward.

    Forward: the fused SDDMM → softmax-stats kernel, then the ParamSpMM
    kernel with its softmax prologue; α is never written out, and the
    residuals are the logits, the two row stats and the output.
    Backward, flash style (the reference's ``f_bwd``)::

        dα  = SDDMM(pcsr, dOut, Vf)               (raw SDDMM kernel)
        α   = exp(logits − rowmax)/rowsum        (recomputed)
        dx  = α ⊙ (dα − dOut·out)                 (softmax vjp)
        de  = dx · scale · LeakyReLU'(x)          (sign of the logits)
        dQ  = SpMM(pcsr,  de, K)                  (ParamSpMM, vals given)
        dK  = SpMM(pcsrᵀ, T(de), Q)
        dVf = SpMM(pcsrᵀ, T(α), dOut)

    ``T`` re-lays slot tensors onto Aᵀ's covered slots through
    ``TransposeSide.src``.  α, dx, de, T(de) and T(α) are one slot pass
    (``kernels.sddmm.ops.gat_backward``: one kernel launch on CUDA
    tensors).  The vjp's Σ_row α·dα is dOut·out per row (``_row_dot``): no
    atomic sum, so the backward is deterministic.  Masked, padding and
    coverage slots carry logit −inf, so α = 0 there, and the raw SDDMM
    writes 0 there, so they add exact zeros."""

    @staticmethod
    def forward(ctx, Q, K_mat, Vf, spec: _GATSpec):
        from repro_torch.kernels.paramspmm import ops as spmm_ops
        from repro_torch.kernels.sddmm import ops as sddmm_ops
        g = spec.geo
        logits, rowmax, rowsum = sddmm_ops._stats_call(
            spec.steer, Q, K_mat, n_blocks=g["n_blocks"], R=g["R"], V=g["V"],
            K=g["K"], n_rows=g["n_rows"],
            scale=float(1.0 / np.sqrt(Q.shape[-1])), slope=spec.slope)
        out = spmm_ops._call(spec.steer, Vf, vals=logits, rowmax=rowmax,
                             rowsum=rowsum, **g)
        ctx.save_for_backward(Q, K_mat, Vf, logits, rowmax, rowsum, out)
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, dOut):
        from repro_torch.kernels.paramspmm import ops as spmm_ops
        from repro_torch.kernels.sddmm import ops as sddmm_ops
        Q, K_mat, Vf, logits, rowmax, rowsum, out = ctx.saved_tensors
        spec, (need_q, need_k, need_v) = ctx.spec, ctx.needs_input_grad[:3]
        if spec.transpose is None:
            raise ValueError("the GAT message backward needs the transpose "
                             "PCSR: build it with make_gat_message_fn(pcsr, "
                             "pcsr_t)")
        t = spec.transpose(dOut.device)
        g, steer = spec.geo, spec.steer
        R, V, K = g["R"], g["V"], g["K"]
        dOut = dOut.contiguous()
        dalpha = rowdot = None
        scale = 1.0
        if need_q or need_k:
            # 1/√d in float32, as the reference computes it
            scale = (1.0 / torch.sqrt(torch.tensor(
                float(Q.shape[-1]), dtype=torch.float32))).item()
            dalpha = sddmm_ops._call(steer, dOut, Vf, n_blocks=g["n_blocks"],
                                     R=R, V=V, K=K, n_rows=g["n_rows"])
            rowdot = _row_dot(dOut, out, g["n_blocks"] * R)
        de, de_t, alpha_t = sddmm_ops.gat_backward(
            steer, t.src, logits, rowmax, rowsum, R=R, V=V, K=K,
            t_shape=t.shape, scale=scale, slope=spec.slope, dalpha=dalpha,
            rowdot=rowdot, need_q=need_q, need_k=need_k, need_v=need_v)
        del dalpha          # read by the slot pass only; may hold de_t/α_t
        dQ = dK = dVf = None
        if need_q:
            dQ = _pad_rows(spmm_ops._call(steer, K_mat, vals=de, **g),
                           Q.shape[-2])
        if need_k:
            dK = _pad_rows(spmm_ops._call(t.steer, Q, vals=de_t, **t.geo),
                           K_mat.shape[-2])
        if need_v:
            dVf = _pad_rows(spmm_ops._call(t.steer, dOut, vals=alpha_t,
                                           **t.geo), Vf.shape[-2])
        return dQ, dK, dVf, None


def gat_message(steer, Q, K_mat, Vf, *, n_blocks, R, V, K, dblk, n_rows,
                slope: float = 0.2, transpose: Optional[Callable] = None):
    """The GAT message over one covered steering: the fused SDDMM →
    softmax-stats kernel, then the ParamSpMM kernel with its softmax
    prologue — two launches on CUDA tensors, their plain versions on CPU
    tensors, α never materialised.  ``(n, d)`` operands return
    ``(n_rows, dv)``; ``(H, n, d)`` ones run every head in the same two
    launches and return ``(H, n_rows, dv)``.  Differentiable in ``Q``,
    ``K_mat`` and ``Vf`` when ``transpose`` (device → ``TransposeSide``)
    is given; the backward raises without it."""
    spec = _GATSpec(steer, dict(n_blocks=n_blocks, R=R, V=V, K=K, dblk=dblk,
                                n_rows=n_rows), float(slope), transpose)
    return _GATMessage.apply(Q, K_mat, Vf, spec)


def gat_message_fn(steer, geo, *, slope: float = 0.2,
                   transpose: Optional[Callable] = None):
    """``f(Q, K, Vf)``: ``gat_message`` over ``steer`` with the geometry
    of ``geo`` — a ``PCSR`` or a serving bucket's ``PackGeom``, both of
    which carry ``config``, ``n_blocks``, ``n_rows`` and ``K``."""
    cfg = geo.config
    return functools.partial(gat_message, steer, n_blocks=geo.n_blocks,
                             R=cfg.R, V=cfg.V, K=geo.K, dblk=cfg.dblk,
                             n_rows=geo.n_rows, slope=slope,
                             transpose=transpose)


def make_gat_message_fn(pcsr: PCSR, pcsr_t: PCSR | None = None, *,
                        slope: float = 0.2):
    """Differentiable GAT message ``f(Q, K, Vf)`` over one PCSR: SDDMM →
    scale 1/√d → LeakyReLU(slope) → edge softmax → SpMM, as two kernel
    launches (``gat_message``) on the inputs' device, with the
    flash-recompute backward (``_GATMessage``).  ``pcsr_t`` is Aᵀ's PCSR
    (``ParamSpMMOperator.pcsr_t``), or a function returning it; without
    it the transpose is packed at the first backward."""
    from repro_torch.kernels.paramspmm.ops import device_steering
    sides: dict = {}

    def transpose(device):
        nonlocal pcsr_t
        key = str(torch.device(device))
        if key not in sides:
            if pcsr_t is None:
                pcsr_t = transpose_pcsr(pcsr)
            elif callable(pcsr_t):
                pcsr_t = pcsr_t()
            sides[key] = TransposeSide.build(pcsr, pcsr_t, device)
        return sides[key]

    def f(Q, K_mat, Vf):
        steer = device_steering(pcsr, Q.device)
        return gat_message_fn(steer, pcsr, slope=slope,
                              transpose=transpose)(Q, K_mat, Vf)
    return f


def _transpose_spmm(pcsr_t, dC, n_rows: int):
    """``dB = SpMM(pcsrᵀ, dC)``, padded to ``n_rows`` rows; ``pcsr_t`` is
    Aᵀ's PCSR or a function returning it."""
    from repro_torch.kernels.paramspmm.ops import paramspmm
    if pcsr_t is None:
        raise ValueError("the SpMM backward needs the transpose PCSR: build "
                         "the operator with build_transpose=True")
    if callable(pcsr_t):
        pcsr_t = pcsr_t()
    return _pad_rows(paramspmm(pcsr_t, dC.contiguous()), n_rows)


class _SpMM(torch.autograd.Function):
    """``C = A·B``; backward ``dB = SpMM(pcsrᵀ, dC)``, one launch."""

    @staticmethod
    def forward(ctx, B, pcsr, pcsr_t):
        from repro_torch.kernels.paramspmm.ops import paramspmm
        ctx.pcsr_t, ctx.b_rows = pcsr_t, B.shape[0]
        return paramspmm(pcsr, B)

    @staticmethod
    def backward(ctx, dC):
        dB = None
        if ctx.needs_input_grad[0]:
            dB = _transpose_spmm(ctx.pcsr_t, dC, ctx.b_rows)
        return dB, None, None


class _FusedSpMM(torch.autograd.Function):
    """``act(scale ⊙ (A·B) + bias + residual)`` in one launch; backward
    from the output (relu and leaky_relu keep the sign, so act' is
    recoverable from it): ``dpre = epilogue_grad(out, dOut)``, ``dbias =
    Σ_rows dpre``, ``dresidual = dpre``, ``dB = SpMM(pcsrᵀ, scale ⊙
    dpre)``.  ``scale`` (degree norms, graph data) gets no gradient."""

    @staticmethod
    def forward(ctx, B, scale, bias, residual, activation, pcsr, pcsr_t):
        from repro_torch.kernels.paramspmm.ops import paramspmm
        out = paramspmm(pcsr, B, scale=scale, bias=bias, residual=residual,
                        activation=activation)
        ctx.save_for_backward(out, scale)
        ctx.activation, ctx.pcsr_t, ctx.b_rows = activation, pcsr_t, \
            B.shape[0]
        return out

    @staticmethod
    def backward(ctx, dOut):
        out, scale = ctx.saved_tensors
        need_b, _, need_bias, need_res = ctx.needs_input_grad[:4]
        dpre = epilogue_grad(out, dOut, ctx.activation)
        dbias = dpre.sum(dim=0) if need_bias else None
        dres = dpre if need_res else None
        dB = None
        if need_b:
            dcb = dpre if scale is None else dpre * scale[:, None]
            dB = _transpose_spmm(ctx.pcsr_t, dcb, ctx.b_rows)
        return dB, None, dbias, dres, None, None, None


def make_spmm_fn(pcsr: PCSR, pcsr_t: PCSR | None = None):
    """Differentiable ``f(B) = A·B`` over ``pcsr``: one ParamSpMM launch
    forward, and backward one launch on Aᵀ's PCSR ``pcsr_t``, or on what
    a function ``pcsr_t`` returns at the first backward (required for
    gradients: the backward raises without it)."""
    def f(B):
        return _SpMM.apply(B, pcsr, pcsr_t)
    return f


def make_fused_spmm_fn(pcsr: PCSR, pcsr_t: PCSR | None = None):
    """The epilogue-fused aggregation ``fused(B, scale=None, bias=None,
    activation="none", residual=None)`` = ``act(scale ⊙ (A·B) + bias +
    residual)``: one launch forward, differentiable in ``B``, ``bias``
    and ``residual`` (GIN's ``(1+ε)h``, whose ε then gets its gradient
    through autograd), backward on ``pcsr_t`` (``_FusedSpMM``)."""
    def fused(B, scale=None, bias=None, activation: str = "none",
              residual=None):
        return _FusedSpMM.apply(B, scale, bias, residual, activation, pcsr,
                                pcsr_t)
    return fused


class ParamSpMMOperator:
    """The operator of one sparse matrix under one ⟨W,F,V,S⟩ config: the
    forward PCSR and (``build_transpose``) Aᵀ's, packed once on the host.
    ``op(B)`` is the differentiable SpMM, ``op.fused(B, scale=, bias=,
    activation=, residual=)`` the epilogue-fused one.  ``device`` stages
    both steerings there up front (otherwise at first use)."""

    def __init__(self, csr: CSRMatrix, config: SpMMConfig, *,
                 build_transpose: bool = True, device=None):
        self.csr = csr
        self.config = config
        with span("pack.pcsr"):
            self.pcsr = build_pcsr(csr.indptr, csr.indices, csr.data,
                                   csr.n_rows, csr.n_cols, config)
            self.pcsr_t = None
            if build_transpose:
                t = csr.transpose()
                self.pcsr_t = build_pcsr(t.indptr, t.indices, t.data,
                                         t.n_rows, t.n_cols, config)
        if device is not None:
            from repro_torch.kernels.paramspmm.ops import device_steering
            for p in (self.pcsr, self.pcsr_t):
                if p is not None:
                    device_steering(p, device)
        self._fn = make_spmm_fn(self.pcsr, self.pcsr_t)
        self.fused = make_fused_spmm_fn(self.pcsr, self.pcsr_t)

    def __call__(self, B):
        return self._fn(B)


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


def epilogue_grad(out, dOut, activation: str = "none", slope: float = 0.2):
    """d(pre-activation) of the fused epilogue from its *output*: relu and
    leaky_relu keep the sign, so act' is recoverable from ``out`` alone."""
    if activation == "relu":
        return torch.where(out > 0, dOut, 0.0)
    if activation == "leaky_relu":
        return torch.where(out >= 0, dOut, slope * dOut)
    if activation != "none":
        raise ValueError(f"unknown epilogue activation {activation!r}")
    return dOut


def engine_spmm_fused(pcsr: PCSR, B, *, scale=None, bias=None,
                      residual=None, activation: str = "none"):
    """act(scale ⊙ (A·B) + bias + residual) on the plain engine — the
    fused kernel's semantics, differentiable through autograd."""
    return apply_epilogue(engine_spmm(pcsr, B), scale, bias, activation,
                          residual=residual)
