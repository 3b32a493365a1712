"""Carry GNN parameters across from numpy.

The JAX package keeps parameters as pytrees: a list of ``{"w", "b"}``
dicts for GCN and of ``{"eps", "w1", "b1", "w2", "b2"}`` dicts for GIN.
Given those as numpy arrays (``np.asarray`` of each leaf), ``params_to_torch``
returns the port's parameters — the same structure as float32 tensors on
one device — so both packages can run the same model.
"""
from __future__ import annotations

import numpy as np
import torch

_KEYS = ({"w", "b"}, {"eps", "w1", "b1", "w2", "b2"})


def params_to_torch(params, device="cpu"):
    """List of dicts of arrays → list of dicts of float32 tensors."""
    out = []
    for i, layer in enumerate(params):
        if set(layer) not in _KEYS:
            raise ValueError(f"layer {i}: keys {sorted(layer)} are neither "
                             "GCN's {w, b} nor GIN's {eps, w1, b1, w2, b2}")
        out.append({k: torch.as_tensor(np.asarray(v, np.float32),
                                       device=device)
                    for k, v in layer.items()})
    return out
