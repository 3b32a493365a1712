"""Plain float32 reference of the published GAT's full-batch training with
AdamW (Veličković et al., Graph Attention Networks, ICLR 2018, arXiv
1710.10903, §2.1 and §3.3's inductive PPI model), on the graph's original
node order.

Per layer and head: ``el = W h · a_l`` and ``er = W h · a_r``, logits
``LeakyReLU_0.2(el_i + er_j)`` on every edge of A + I, the softmax over
each row's edges (``scatter_reduce`` max, ``index_add_`` Σexp) and the
aggregation ``Σ_j α_ij W h_j`` by gathers and ``index_add_``.  Hidden
layers concatenate their heads and add ELU; the last averages its heads;
the loss is the mean sigmoid cross-entropy over the train rows × labels.
The aggregation runs one head at a time over blocks of edges, forward
and backward (``_HeadAgg``), so a 1,024-wide layer on millions of edges
fits on the card beside nothing else.  TF32 is off unless the caller asks
for it (the lower-precision control).  It imports nothing of the program
and takes nothing the program made; the tests' copy is
``tests/plain_gat_additive.py``.

Departures from the paper (the same as the tests' copy):

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

EDGE_BLOCK = 1 << 20          # edges a gather block holds
SLOPE = 0.2


class Adjacency:
    """The edges of A + I for a symmetric binary adjacency without self
    loops, on ``device``: rows and columns sorted by row, then column
    (an edge (i, j) is a message from j to i)."""

    def __init__(self, indptr, indices, n: int, device):
        ip = torch.as_tensor(indptr, dtype=torch.int64, device=device)
        cols = torch.as_tensor(indices, dtype=torch.int64, device=device)
        rows = torch.repeat_interleave(torch.arange(n, device=device),
                                       ip[1:] - ip[:-1])
        ids = torch.arange(n, device=device)
        rows, cols = torch.cat([rows, ids]), torch.cat([cols, ids])
        order = torch.argsort(rows * n + cols)
        self.rows, self.cols = rows[order], cols[order]
        self.n, self.nnz = n, int(self.rows.numel())

    def blocks(self):
        for s in range(0, self.nnz, EDGE_BLOCK):
            yield slice(s, min(s + EDGE_BLOCK, self.nnz))


class _HeadAgg(torch.autograd.Function):
    """``out[i] = Σ_e α[e]·v[col_e]`` over the edges of row i, for one
    head (``alpha`` (E,), ``v`` (n, F)), in edge blocks; the backward
    ``dα[e] = dout[row_e]·v[col_e]`` and ``dv[j] = Σ_e α[e]·dout[row_e]``
    over the edges of column j, in the same blocks."""

    @staticmethod
    def forward(ctx, alpha, v, adj):
        ctx.save_for_backward(alpha, v)
        ctx.adj = adj
        out = torch.zeros_like(v)
        for b in adj.blocks():
            out.index_add_(0, adj.rows[b], alpha[b, None] * v[adj.cols[b]])
        return out

    @staticmethod
    def backward(ctx, dout):
        alpha, v = ctx.saved_tensors
        adj = ctx.adj
        dalpha = torch.empty_like(alpha)
        dv = torch.zeros_like(v)
        for b in adj.blocks():
            r, c = adj.rows[b], adj.cols[b]
            dalpha[b] = (dout[r] * v[c]).sum(-1)
            dv.index_add_(0, c, alpha[b, None] * dout[r])
        return dalpha, dv, None


def _same(x):
    return x


def attention(el, er, adj, slope=SLOPE):
    """α over each row's edges of LeakyReLU(el_i + er_j): ``(E, H)``."""
    e = el[adj.rows] + er[adj.cols]
    e = torch.where(e >= 0, e, slope * e)
    with torch.no_grad():
        mx = torch.full((adj.n, e.shape[1]), -torch.inf, device=e.device)
        mx = mx.scatter_reduce(0, adj.rows[:, None].expand_as(e), e, "amax")
    ex = torch.exp(e - mx[adj.rows])
    den = torch.zeros((adj.n, e.shape[1]), device=e.device,
                      dtype=e.dtype).index_add(0, adj.rows, ex)
    return ex / den[adj.rows]


def layer(h, p, adj, last: bool, skip: bool, fault=_same):
    """One attention layer: ``p`` holds ``w`` (d_in × H·F′), ``al`` and
    ``ar`` (H × F′) and ``b``.  ``fault`` is applied to every head's
    aggregation."""
    n, (H, F) = h.shape[0], p["al"].shape
    wh = (h @ p["w"]).view(n, H, F)
    el, er = (wh * p["al"]).sum(-1), (wh * p["ar"]).sum(-1)     # (n, H)
    alpha = attention(el, er, adj)
    heads = [fault(_HeadAgg.apply(alpha[:, k].contiguous(),
                                  wh[:, k].contiguous(), adj))
             for k in range(H)]
    if last:
        return torch.stack(heads, 0).mean(dim=0) + p["b"]
    out = torch.cat(heads, -1) + p["b"]
    if skip and out.shape == h.shape:
        out = out + h
    return torch.nn.functional.elu(out)


def forward(config, params, X, adj, fault=_same):
    h = X
    for i, p in enumerate(params):
        h = layer(h, p, adj, i == len(params) - 1, config.get("skip", True),
                  fault)
    return h


def node_loss(logits, labels, mask):
    """Mean sigmoid cross-entropy over the rows where ``mask`` is 1 and
    their labels."""
    per = torch.nn.functional.binary_cross_entropy_with_logits(
        logits, labels, reduction="none").sum(-1)
    return (per * mask).sum() / (mask.sum() * labels.shape[-1])


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 matmuls on or off for the block (off is float32)."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def train(config, params, X, labels, mask, adj, steps, *, use_tf32=False,
          loss_fn=node_loss, fault=_same):
    """``steps`` full-batch AdamW steps from ``params`` (a list of dicts
    of tensors, left as they are).  Returns (losses, the first step's
    gradients, the parameters after the last step).  ``loss_fn`` and
    ``fault`` (applied to every head's aggregation) plant the faults that
    the comparison is shown to catch."""
    opt = config["adamw"]
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    wd = opt.get("weight_decay", 0.0)
    p = [{k: v.detach().clone().float() for k, v in lay.items()}
         for lay in params]
    m = [{k: torch.zeros_like(v) for k, v in lay.items()} for lay in p]
    s = [{k: torch.zeros_like(v) for k, v in lay.items()} for lay in p]
    losses, first = [], None
    with tf32(use_tf32):
        for t in range(1, steps + 1):
            leaves = [v.requires_grad_() for lay in p for v in lay.values()]
            loss = loss_fn(forward(config, p, X, adj, fault), labels, mask)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss.detach()))
            del loss
            it = iter(grads)
            g = [{k: next(it) for k in lay} for lay in p]
            if first is None:
                first = [{k: v.detach().clone() for k, v in lay.items()}
                         for lay in g]
            b1c, b2c = 1.0 - b1 ** t, 1.0 - b2 ** t
            with torch.no_grad():
                for lp, lg, lm, ls in zip(p, g, m, s):
                    for k in lp:
                        lm[k] = b1 * lm[k] + (1 - b1) * lg[k]
                        ls[k] = b2 * ls[k] + (1 - b2) * lg[k] * lg[k]
                        upd = (lm[k] / b1c) / (torch.sqrt(ls[k] / b2c) + eps)
                        lp[k] = lp[k] - lr * (upd + wd * lp[k])
    p = [{k: v.detach() for k, v in lay.items()} for lay in p]
    return losses, first, p
