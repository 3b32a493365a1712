"""Top-k gradient sparsification with error feedback, as the JAX
package's ``optim/compression.py``: each leaf sends its largest-magnitude
fraction of ``g + e`` and keeps the rest, in float32, as the next step's
error memory (``launch/train.py --compress``)."""
from __future__ import annotations

import torch

from .adamw import tree_map


def topk_compress_init(params):
    """Zero error memory, float32, shaped like ``params``."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _topk_mask(x, frac: float):
    """1 where |x| is at least its k-th largest magnitude, k = max(1,
    ⌊numel · frac⌋) (ties all kept), else 0, in x's dtype."""
    k = max(1, int(x.numel() * frac))
    thresh = torch.topk(x.abs().reshape(-1), k).values[-1]
    return (x.abs() >= thresh).to(x.dtype)


@torch.no_grad()
def topk_compress_apply(grads, error, frac: float = 0.05):
    """Returns (compressed grads in each leaf's dtype, new error memory)."""
    def one(g, e):
        g32 = g.float() + e
        sent = g32 * _topk_mask(g32, frac)
        return sent.to(g.dtype), g32 - sent

    out = tree_map(one, grads, error)
    return (tree_map(lambda _, o: o[0], grads, out),
            tree_map(lambda _, o: o[1], grads, out))
