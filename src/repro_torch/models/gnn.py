"""GCN and GIN (paper §6.5) with pluggable sparse aggregation, forward only.

The forwards take an ``spmm: (n, d) -> (n, d)`` closure over the graph.
Closures that also expose ``.fused(B, scale=, bias=, activation=,
residual=)`` get each GCN layer's bias + ReLU, and each GIN layer's
``(1+ε)h`` term, handed to the SpMM's fused epilogue — one kernel per
aggregation.  The fuse rules are the JAX package's, so the port launches
the same kernels in the same order.  Parameters are lists of dicts of
tensors; ``repro_torch.convert`` carries them over from numpy.
"""
from __future__ import annotations

import inspect

import torch


def _dense_init(fan_in, fan_out, generator, device):
    scale = (2.0 / fan_in) ** 0.5
    w = torch.randn((fan_in, fan_out), generator=generator,
                    dtype=torch.float32) * scale
    return w.to(device)


# -------------------------------------------------------------------- GCN
def init_gcn(layer_dims, *, generator: torch.Generator, device="cpu"):
    """layer_dims e.g. [16, 64, 64, 64, 64, 16] → 5 layers (paper setup)."""
    return [{"w": _dense_init(layer_dims[i], layer_dims[i + 1], generator,
                              device),
             "b": torch.zeros(layer_dims[i + 1], device=device)}
            for i in range(len(layer_dims) - 1)]


def gcn_forward(params, X, spmm):
    """One GCN layer is ``relu(Â·H·W + b)``.  With a fused closure the
    layer reassociates to ``Â·(H·W)`` and bias + activation ride the SpMM
    epilogue — only when ``d_out ≤ d_in``, so the SpMM never widens."""
    fused = getattr(spmm, "fused", None)
    h = X
    for i, layer in enumerate(params):
        last = i == len(params) - 1
        w = layer["w"]
        if fused is not None and w.shape[1] <= w.shape[0]:
            h = fused(h @ w, bias=layer["b"],
                      activation="none" if last else "relu")
        else:
            h = spmm(h) @ w + layer["b"]               # Â·H·W
            if not last:
                h = torch.relu(h)
    return h


# -------------------------------------------------------------------- GIN
def init_gin(layer_dims, *, generator: torch.Generator, device="cpu",
             mlp_hidden_mult: int = 1):
    params = []
    for i in range(len(layer_dims) - 1):
        hid = layer_dims[i + 1] * mlp_hidden_mult
        params.append({
            "eps": torch.zeros((), device=device),
            "w1": _dense_init(layer_dims[i], hid, generator, device),
            "b1": torch.zeros(hid, device=device),
            "w2": _dense_init(hid, layer_dims[i + 1], generator, device),
            "b2": torch.zeros(layer_dims[i + 1], device=device),
        })
    return params


def gin_forward(params, X, spmm):
    """GIN aggregation is ``(1+ε)h + A·h``.  With a residual-capable fused
    closure the ``(1+ε)h`` term is the epilogue's dense residual addend:
    one kernel per aggregation."""
    fused = getattr(spmm, "fused", None)
    if fused is not None:
        try:
            if "residual" not in inspect.signature(fused).parameters:
                fused = None
        except (TypeError, ValueError):
            fused = None
    h = X
    for i, layer in enumerate(params):
        if fused is not None:
            agg = fused(h, residual=(1.0 + layer["eps"]) * h)
        else:
            agg = (1.0 + layer["eps"]) * h + spmm(h)   # (1+ε)h + A·h
        z = torch.relu(agg @ layer["w1"] + layer["b1"])
        h = z @ layer["w2"] + layer["b2"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


# -------------------------------------------------------------------- GAT
def gat_forward(params, X, gat_msg, heads: int = 1):
    raise NotImplementedError(
        "GAT needs the SDDMM→softmax kernel and the SpMM prologue, which "
        "come with the next slice of the port (ROADMAP Queue 1)")
