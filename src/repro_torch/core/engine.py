"""ParamSpMM computing engine (paper Alg. 2) in plain PyTorch, forward only.

The same PCSR traversal as the CUDA kernel, expressed as gather +
``index_add_``: the kernel's plain version (``kernels.paramspmm.ops.
paramspmm_plain`` is this engine plus ``apply_epilogue``) and the
semantics every backend is held to.  The differentiable operators and the
GAT message come with later slices of the port.
"""
from __future__ import annotations

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
