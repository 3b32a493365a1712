"""Carry GNN and LM parameters across from numpy.

The JAX package keeps parameters as pytrees: a list of ``{"w", "b"}``
dicts for GCN, of ``{"eps", "w1", "b1", "w2", "b2"}`` dicts for GIN and
of ``{"wq", "wk", "wv", "b"}`` dicts for GAT.
Given those as numpy arrays (``np.asarray`` of each leaf), ``params_to_torch``
returns the port's parameters — the same structure as float32 tensors on
one device — so both packages can run the same model.
``lm_params_to_torch`` does the same for the LM side's nested dicts,
keeping each leaf's dtype (bf16 weights, float32 ``a_log``).
``decider_to_torch`` carries a trained SpMM-decider across: its random
forest node by node, and its config space.
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


def decider_to_torch(ref_decider):
    """A decider of the JAX package (``repro.core.decider.SpMMDecider``)
    → the port's, with the same trees and config space, so it predicts
    the same configs.  The reference is read by attribute only
    (``space`` as ``astuple()``s; ``forest.trees``; each node's
    ``feature``/``threshold``/``left``/``right``/``value``): a pickle of
    it names the reference's classes, which the port never imports."""
    from repro_torch.core.decider import (DecisionTree, RandomForest,
                                          SpMMDecider, _Node)
    from repro_torch.core.pcsr import SpMMConfig

    def node(ref):
        out = _Node(None if ref.value is None
                    else np.array(ref.value, np.float64))
        if ref.value is None:
            out.feature, out.threshold = int(ref.feature), \
                float(ref.threshold)
            out.left, out.right = node(ref.left), node(ref.right)
        return out

    ref_forest = ref_decider.forest
    forest = RandomForest(n_estimators=ref_forest.n_estimators,
                          max_depth=ref_forest.max_depth,
                          min_samples_leaf=ref_forest.min_samples_leaf,
                          seed=ref_forest.seed)
    forest.n_classes = int(ref_forest.n_classes)
    for ref_tree in ref_forest.trees:
        tree = DecisionTree(ref_tree.max_depth, ref_tree.min_samples_leaf,
                            ref_tree.max_features)
        tree.n_classes = int(ref_tree.n_classes)
        tree.root = node(ref_tree.root)
        forest.trees.append(tree)
    space = []
    for c in ref_decider.space:
        w, f, v, s, b = c.astuple()
        space.append(SpMMConfig(V=int(v), S=bool(s), F=int(f), W=int(w),
                                B=bool(b)))
    return SpMMDecider(space=space, forest=forest)
