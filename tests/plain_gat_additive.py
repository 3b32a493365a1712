"""Plain PyTorch reference of the published GAT (Veličković et al.,
Graph Attention Networks, ICLR 2018, arXiv 1710.10903, §2.1 and §3.3's
inductive PPI model) and its full-batch training with AdamW.

Float32 on edge lists: the logits ``e_ij = LeakyReLU_0.2(a_lᵀ W h_i +
a_rᵀ W h_j)`` over every edge of A + I (N(i) ∪ {i}), the softmax by
``scatter_reduce`` (max) and ``index_add_`` (Σexp) per destination row,
and the aggregation ``Σ_j α_ij W h_j`` by ``index_add_``.  Hidden layers
concatenate their heads, the last averages them; ELU between layers; the
loss is the mean sigmoid cross-entropy over the train rows × labels.
TF32 is off while it runs.  It imports no kernel of the port and no JAX.

Departures from the paper (the benchmark's copy,
``perfbench/reference/gat_ppi.py``, lists the same):

* the skip is an identity on the concatenation, added before the ELU
  where a hidden layer keeps its width (the paper's text; the authors'
  code projects it per head);
* a bias per layer, zero at the start;
* He-normal weights and attention vectors, not Glorot;
* full-batch steps on one graph, not batches of 2 PPI graphs;
* AdamW with no decay in place of Adam (the same update);
* no dropout and no L2 (the PPI model has none).
"""
from __future__ import annotations

import contextlib

import torch

SLOPE = 0.2


def edges(indptr, indices, n: int):
    """Rows and columns of A + I for a binary adjacency without self
    loops in CSR: each edge (i, j) is a message from j to i."""
    ip = torch.as_tensor(indptr, dtype=torch.int64)
    cols = torch.as_tensor(indices, dtype=torch.int64)
    rows = torch.repeat_interleave(torch.arange(n), ip[1:] - ip[:-1])
    ids = torch.arange(n)
    return torch.cat([rows, ids]), torch.cat([cols, ids])


def logits(el, er, rows, cols, slope=SLOPE):
    """LeakyReLU(el_i + er_j) per edge and head."""
    e = el[rows] + er[cols]
    return torch.where(e >= 0, e, slope * e)


def layer(h, p, rows, cols, last: bool, skip: bool):
    """One attention layer: ``p`` holds ``w`` (d_in × H·F′), ``al`` and
    ``ar`` (H × F′) and ``b``."""
    n, (H, F) = h.shape[0], p["al"].shape
    wh = (h @ p["w"]).view(n, H, F)
    el, er = (wh * p["al"]).sum(-1), (wh * p["ar"]).sum(-1)     # (n, H)
    e = logits(el, er, rows, cols)
    with torch.no_grad():
        mx = torch.full((n, H), -torch.inf).scatter_reduce(
            0, rows[:, None].expand_as(e), e, "amax")
    ex = torch.exp(e - mx[rows])
    alpha = ex / torch.zeros((n, H)).index_add(0, rows, ex)[rows]
    out = torch.zeros((n, H, F)).index_add(0, rows,
                                           alpha[..., None] * wh[cols])
    if last:
        return out.mean(dim=1) + p["b"]
    out = out.reshape(n, H * F) + p["b"]
    if skip and out.shape == h.shape:
        out = out + h
    return torch.nn.functional.elu(out)


def forward(params, X, rows, cols, skip=True):
    h = X
    for i, p in enumerate(params):
        h = layer(h, p, rows, cols, i == len(params) - 1, skip)
    return h


def loss(out, labels, mask):
    """Mean sigmoid cross-entropy over the rows where ``mask`` is 1 and
    their labels."""
    per = torch.nn.functional.binary_cross_entropy_with_logits(
        out, labels, reduction="none").sum(-1)
    return (per * mask).sum() / (mask.sum() * labels.shape[-1])


@contextlib.contextmanager
def no_tf32():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def train(params, X, labels, mask, rows, cols, steps, *, lr=0.005, b1=0.9,
          b2=0.999, eps=1e-8):
    """``steps`` AdamW steps (no decay) from ``params``: (losses, the
    first step's gradients, the parameters after the last step)."""
    p = [{k: v.detach().clone() for k, v in lay.items()} for lay in params]
    m = [{k: torch.zeros_like(v) for k, v in lay.items()} for lay in p]
    s = [{k: torch.zeros_like(v) for k, v in lay.items()} for lay in p]
    losses, first = [], None
    with no_tf32():
        for t in range(1, steps + 1):
            leaves = [v.requires_grad_() for lay in p for v in lay.values()]
            value = loss(forward(p, X, rows, cols), labels, mask)
            grads = torch.autograd.grad(value, leaves)
            losses.append(float(value.detach()))
            it = iter(grads)
            g = [{k: next(it) for k in lay} for lay in p]
            if first is None:
                first = g
            with torch.no_grad():
                for lp, lg, lm, ls in zip(p, g, m, s):
                    for k in lp:
                        lm[k] = b1 * lm[k] + (1 - b1) * lg[k]
                        ls[k] = b2 * ls[k] + (1 - b2) * lg[k] * lg[k]
                        upd = (lm[k] / (1 - b1 ** t)) / (
                            torch.sqrt(ls[k] / (1 - b2 ** t)) + eps)
                        lp[k] = lp[k] - lr * upd
    return losses, first, [{k: v.detach() for k, v in lay.items()}
                           for lay in p]
