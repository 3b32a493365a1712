"""Carry GNN and LM parameters across from numpy.

The JAX package keeps parameters as pytrees: a list of ``{"w", "b"}``
dicts for GCN, of ``{"eps", "w1", "b1", "w2", "b2"}`` dicts for GIN and
of ``{"wq", "wk", "wv", "b"}`` dicts for GAT.
Given those as numpy arrays (``np.asarray`` of each leaf), ``params_to_torch``
returns the port's parameters — the same structure as float32 tensors on
one device — so both packages can run the same model.
``lm_params_to_torch`` does the same for the LM side's nested dicts,
keeping each leaf's dtype (bf16 weights, float32 ``a_log``).
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


def lm_params_to_torch(params, device="cpu"):
    """The JAX package's LM parameters — a nested dict of numpy arrays
    (``np.asarray`` of each leaf) — → the same nesting of tensors, each
    leaf's dtype kept.  bfloat16 leaves (numpy's ``ml_dtypes.bfloat16``,
    which torch does not take) go across bit for bit as their uint16
    pattern, viewed as ``torch.bfloat16``."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = lm_params_to_torch(v, device)
            continue
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        out[k] = t.to(device)
    return out
