"""Carry GNN parameters across from numpy.

The JAX package keeps parameters as pytrees: a list of ``{"w", "b"}``
dicts for GCN, of ``{"eps", "w1", "b1", "w2", "b2"}`` dicts for GIN and
of ``{"wq", "wk", "wv", "b"}`` dicts for GAT.
Given those as numpy arrays (``np.asarray`` of each leaf), ``params_to_torch``
returns the port's parameters — the same structure as float32 tensors on
one device — so both packages can run the same model.
"""
from __future__ import annotations

import numpy as np
import torch

_KEYS = ({"w", "b"}, {"eps", "w1", "b1", "w2", "b2"},
         {"wq", "wk", "wv", "b"})


def params_to_torch(params, device="cpu"):
    """List of dicts of arrays → list of dicts of float32 tensors."""
    out = []
    for i, layer in enumerate(params):
        if set(layer) not in _KEYS:
            raise ValueError(f"layer {i}: keys {sorted(layer)} are none of "
                             "GCN's {w, b}, GIN's {eps, w1, b1, w2, b2} "
                             "and GAT's {wq, wk, wv, b}")
        out.append({k: torch.as_tensor(np.array(v, np.float32),
                                       device=device)
                    for k, v in layer.items()})
    return out
