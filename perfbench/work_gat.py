"""The work of a training step of the published GAT (additive attention,
``configs/gatppi.json``), counted from shapes with ``work.py``'s ``Op``,
families, byte rules and peaks.

Per layer of ``H`` heads of ``F′`` (the message width): the dense
``H·W`` (forward, dW and, past the first layer, dX); the fused SDDMM →
softmax stats on the 2-wide operands ``[el, 1]`` and ``[1, er]``, whose
dot is ``el_i + er_j``; the SpMM with its softmax prologue at ``F′``;
backward the raw SDDMM (dα) at ``F′``, dQ on A and dK on Aᵀ at width 2
(Σ_j de_ij and Σ_i de_ij, the gradients of el and er) and dVf on Aᵀ at
``F′``.  The el/er products, the skip, the ELU and the loss are
elementwise and not counted, as in ``work.py``.
"""
from __future__ import annotations

from perfbench.work import F4, Op, _matmuls, csr_bytes

ATT = 2            # width of the attention operands [el, 1] and [1, er]


def head_dims(dims, heads):
    """Per layer ``(H, F′)``: hidden layers concatenate ``H`` heads of
    ``width / H``, the last averages ``H`` heads of its full width."""
    L = len(dims) - 1
    return [(H, dims[i + 1] // H if i < L - 1 else dims[i + 1])
            for i, H in enumerate(heads)]


def step_ops(config: dict, n: int, nnz: int) -> list[Op]:
    """The ops of one training step of ``config`` on a graph of ``n``
    nodes and ``nnz`` nonzeros of A + I (read as its pattern)."""
    dims, ops = config["dims"], []
    p = csr_bytes(n, nnz, values=False)
    for i, (H, F) in enumerate(head_dims(dims, config["heads"])):
        ops += _matmuls(n, dims[i], H * F, i == 0, f"layer {i} H·W")
        edge = F4 * H * nnz                      # one float a slot and head
        qa, qv = F4 * H * n * ATT, F4 * H * n * F
        stats = 2 * F4 * H * n
        f_a, f_v = 2.0 * H * nnz * ATT, 2.0 * H * nnz * F
        ops += [
            Op("sddmm_softmax", f"layer {i} SDDMM→softmax d={ATT}",
               p + 2 * qa + edge + stats, f_a, ATT, H),
            Op("paramspmm", f"layer {i} α·V d={F}",
               p + edge + stats + 2 * qv, f_v, F, H),
            Op("sddmm", f"layer {i} dα d={F}", p + 2 * qv + edge, f_v, F, H),
            Op("paramspmm", f"layer {i} dQ d={ATT}", p + edge + 2 * qa, f_a,
               ATT, H),
            Op("paramspmm", f"layer {i} dK d={ATT}", p + edge + 2 * qa, f_a,
               ATT, H),
            Op("paramspmm", f"layer {i} dVf d={F}", p + edge + 2 * qv, f_v,
               F, H),
        ]
    return ops


def gemm_flops(ops) -> float:
    """FLOPs of the step's dense matmuls."""
    return sum(o.flops for o in ops if o.family == "matmul")
