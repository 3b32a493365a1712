"""The work a GNN training step needs, counted from shapes, and the
card's peaks: the yardstick of the roofline and MFU metrics.

Copied from the arithmetic of ``chip_smoke.py`` (``_bound``,
``_csr_bytes``, ``launches_per_step``, the kernel families) and widened
to the heads and widths of each launch.  Bytes: each input read once and
each output written once, A as CSR at 4 bytes a row pointer, a column
and (where the function needs it) a value; PCSR padding and steering
tables are the format's own traffic and are not counted.  FLOPs: an
aggregation or an SDDMM is 2·nnz·d per head; a dense matmul 2·n·d_in·d_out,
three times over for forward and backward (twice where the input needs no
gradient).  Elementwise work is not counted.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
F4 = 4                          # bytes of a float32, an int32 index

# profiler kernel names → family; a split group's merge kernel is its
# kernel's family (it runs inside the same wrapper call)
FAMILIES = (("paramspmm", ("paramspmm_kernel", "paramspmm_merge_kernel")),
            ("sddmm_softmax", ("sddmm_softmax_kernel",
                               "sddmm_softmax_merge_kernel")),
            ("sddmm", ("sddmm_kernel",)))


def kernel_family(name: str) -> str:
    """The family of a device op's name, or "other"."""
    for fam, names in FAMILIES:
        for k in names:
            if k + "<" in name or k + "(" in name or name == k:
                return fam
    return "other"


@dataclass(frozen=True)
class Op:
    family: str        # paramspmm, sddmm_softmax, sddmm, or matmul
    what: str
    bytes: float
    flops: float
    width: int = 0     # an aggregation's width per head
    heads: int = 1

    def least_s(self) -> float:
        """Least time: bytes over the HBM rate against FLOPs over the
        float32 peak, whichever is larger."""
        return max(self.bytes / HBM_BYTES_PER_S, self.flops / F32_FLOP_PER_S)


def csr_bytes(n: int, nnz: int, values: bool = True) -> int:
    """What any format must read of A: a row pointer, a column per
    nonzero and, with ``values``, a value per nonzero."""
    return F4 * (n + 1 + nnz * (2 if values else 1))


def _matmuls(n, d_in, d_out, first, what):
    """Forward, dW and (unless ``first``) dX of ``X·W``."""
    f = 2.0 * n * d_in * d_out
    return [Op("matmul", f"{what} {kind}", 0.0, f)
            for kind in (("fwd", "dW") if first else ("fwd", "dW", "dX"))]


def gcn_step(dims, n, nnz, fused=True):
    """GCN: per layer ``relu(Â·H·W + b)``; with the fused epilogue a
    layer whose width does not grow runs ``Â·(H·W)`` with bias and ReLU in
    the SpMM, else ``(Â·H)·W``.  Each SpMM has a backward SpMM on Âᵀ
    unless its operand needs no gradient (the first layer's features)."""
    ops = []
    a = csr_bytes(n, nnz)
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        ops += _matmuls(n, d_in, d_out, i == 0, f"layer {i} H·W")
        if fused and d_out <= d_in:
            w, grad = d_out, True              # Â·(H·W) + b, relu
            extra = F4 * d_out                 # the bias
        else:
            w, grad = d_in, i > 0              # Â·H
            extra = 0
        ops.append(Op("paramspmm", f"layer {i} Â·B d={w}",
                      a + 2 * F4 * n * w + extra, 2.0 * nnz * w, w))
        if grad:
            ops.append(Op("paramspmm", f"layer {i} Âᵀ·dC d={w}",
                          a + 2 * F4 * n * w, 2.0 * nnz * w, w))
    return ops


def gat_step(dims, n, nnz, heads=1):
    """Dot-product GAT with ``heads`` heads (hidden layers concatenate
    them, the last averages): per layer the fused SDDMM → softmax stats
    and the SpMM with its softmax prologue forward; backward the raw SDDMM
    (dα) and three SpMMs (dQ on A, dK and dVf on Aᵀ).  A is read as its
    pattern (attention needs no values); the slot tensors (logits, dα,
    α) are one float per nonzero and head."""
    ops = []
    H = heads
    p = csr_bytes(n, nnz, values=False)
    edge = F4 * H * nnz
    L = len(dims) - 1
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        dv = d_out // H if (H > 1 and i < L - 1) else d_out
        da = dv
        for proj, w in (("Q", da), ("K", da), ("V", dv)):
            ops += _matmuls(n, d_in, H * w, i == 0, f"layer {i} H·W{proj}")
        qa, qv = F4 * H * n * da, F4 * H * n * dv
        stats = 2 * F4 * H * n
        f_a, f_v = 2.0 * H * nnz * da, 2.0 * H * nnz * dv
        ops += [
            Op("sddmm_softmax", f"layer {i} SDDMM→softmax d={da}",
               p + 2 * qa + edge + stats, f_a, da, H),
            Op("paramspmm", f"layer {i} α·V d={dv}",
               p + edge + stats + 2 * qv, f_v, dv, H),
            Op("sddmm", f"layer {i} dα d={dv}", p + 2 * qv + edge, f_v, dv,
               H),
            Op("paramspmm", f"layer {i} dQ d={da}", p + edge + 2 * qa, f_a,
               da, H),
            Op("paramspmm", f"layer {i} dK d={da}", p + edge + 2 * qa, f_a,
               da, H),
            Op("paramspmm", f"layer {i} dVf d={dv}", p + edge + 2 * qv, f_v,
               dv, H),
        ]
    return ops


def step_ops(config: dict, n: int, nnz: int) -> list[Op]:
    """The ops of one training step of ``config`` on a graph of ``n``
    nodes and ``nnz`` nonzeros of Â."""
    if config["model"] == "gcn":
        return gcn_step(config["dims"], n, nnz, config.get("fused", True))
    if config["model"] == "gat":
        return gat_step(config["dims"], n, nnz, config.get("heads", 1))
    raise ValueError(f"no work count for model {config['model']!r}")


def least_s(ops, families) -> float:
    """Least time of the ops of ``families``."""
    return sum(o.least_s() for o in ops if o.family in families)


def model_flops(ops) -> float:
    return sum(o.flops for o in ops)


def launches(ops) -> dict:
    """Kernel launches a step makes, by family (one op, one launch)."""
    out: dict = {}
    for o in ops:
        if o.family != "matmul":
            out[o.family] = out.get(o.family, 0) + 1
    return out
