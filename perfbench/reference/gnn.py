"""Plain float32 reference of full-batch GCN and dot-product GAT training
with AdamW, on the graph's original node order.

It builds Â = D^-1/2 (A + I) D^-1/2 from the raw CSR itself, aggregates
with ``torch.sparse.mm`` (GCN) or gathers and ``index_add_`` over the
edges in blocks (GAT), and runs its own AdamW.  TF32 is off unless the
caller asks for it (the lower-precision control).  It imports nothing of
the program and takes nothing the program made.
"""
from __future__ import annotations

import contextlib
import math
import warnings

import torch

# torch.sparse's CSR support is flagged beta on every use
warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")

EDGE_BLOCK = 1 << 20          # edges a gather block holds


class Adjacency:
    """Â of a symmetric binary adjacency without self loops, on
    ``device``: COO rows/cols (sorted by row, then column), values, and
    the CSR tensors of Â and Âᵀ."""

    def __init__(self, indptr, indices, n: int, device):
        ip = torch.as_tensor(indptr, dtype=torch.int64, device=device)
        cols = torch.as_tensor(indices, dtype=torch.int64, device=device)
        deg = ip[1:] - ip[:-1]
        rows = torch.repeat_interleave(torch.arange(n, device=device), deg)
        ids = torch.arange(n, device=device)
        rows = torch.cat([rows, ids])
        cols = torch.cat([cols, ids])
        order = torch.argsort(rows * n + cols)
        self.rows, self.cols = rows[order], cols[order]
        self.n, self.nnz = n, int(self.rows.numel())
        d = torch.bincount(self.rows, minlength=n).to(torch.float32)
        dinv = 1.0 / torch.sqrt(torch.clamp_min(d, 1.0))
        self.vals = dinv[self.rows] * dinv[self.cols]
        crow = torch.zeros(n + 1, dtype=torch.int64, device=device)
        crow[1:] = torch.cumsum(torch.bincount(self.rows, minlength=n), 0)
        self.csr = torch.sparse_csr_tensor(crow, self.cols, self.vals,
                                           (n, n), check_invariants=False)
        t = torch.argsort(self.cols * n + self.rows)
        tcrow = torch.zeros(n + 1, dtype=torch.int64, device=device)
        tcrow[1:] = torch.cumsum(torch.bincount(self.cols, minlength=n), 0)
        self.csr_t = torch.sparse_csr_tensor(tcrow, self.rows[t],
                                             self.vals[t], (n, n),
                                             check_invariants=False)

    def blocks(self):
        for s in range(0, self.nnz, EDGE_BLOCK):
            yield slice(s, min(s + EDGE_BLOCK, self.nnz))


class _SpMM(torch.autograd.Function):
    """Â·B with the backward Âᵀ·dC."""

    @staticmethod
    def forward(ctx, B, adj):
        ctx.adj = adj
        return torch.sparse.mm(adj.csr, B)

    @staticmethod
    def backward(ctx, dC):
        return torch.sparse.mm(ctx.adj.csr_t, dC.contiguous()), None


class _EdgeDot(torch.autograd.Function):
    """s[e, h] = q[row_e, h]·k[col_e, h] over Â's edges, in blocks."""

    @staticmethod
    def forward(ctx, q, k, adj):
        ctx.save_for_backward(q, k)
        ctx.adj = adj
        s = q.new_empty((adj.nnz, q.shape[1]))
        for b in adj.blocks():
            s[b] = (q[adj.rows[b]] * k[adj.cols[b]]).sum(-1)
        return s

    @staticmethod
    def backward(ctx, ds):
        q, k = ctx.saved_tensors
        adj = ctx.adj
        dq, dk = torch.zeros_like(q), torch.zeros_like(k)
        for b in adj.blocks():
            r, c, g = adj.rows[b], adj.cols[b], ds[b][..., None]
            dq.index_add_(0, r, g * k[c])
            dk.index_add_(0, c, g * q[r])
        return dq, dk, None


class _EdgeAgg(torch.autograd.Function):
    """out[i, h] = Σ_e α[e, h]·v[col_e, h] over the edges of row i."""

    @staticmethod
    def forward(ctx, alpha, v, adj):
        ctx.save_for_backward(alpha, v)
        ctx.adj = adj
        out = torch.zeros_like(v)
        for b in adj.blocks():
            out.index_add_(0, adj.rows[b], alpha[b][..., None]
                           * v[adj.cols[b]])
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
            dv.index_add_(0, c, alpha[b][..., None] * dout[r])
        return dalpha, dv, None


def _same(x):
    return x


def gcn_forward(params, X, adj, fused=True, fault=_same):
    """``relu(Â·H·W + b)`` per layer, none after the last; ``Â·(H·W)``
    where the layer does not widen (``fused``), else ``(Â·H)·W``.
    ``fault`` is applied to every aggregation's output."""
    h = X
    for i, layer in enumerate(params):
        w = layer["w"]
        if fused and w.shape[1] <= w.shape[0]:
            h = fault(_SpMM.apply(h @ w, adj)) + layer["b"]
        else:
            h = fault(_SpMM.apply(h, adj)) @ w + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def gat_message(q, k, v, adj, slope=0.2, fault=_same):
    """softmax over each row's edges of LeakyReLU(q_i·k_j/√d), then the
    α-weighted sum of v_j; ``(n, H, d)`` operands."""
    s = _EdgeDot.apply(q, k, adj) / math.sqrt(q.shape[-1])
    s = torch.where(s >= 0, s, slope * s)
    with torch.no_grad():
        mx = torch.full((adj.n, s.shape[1]), -torch.inf, device=s.device)
        mx = mx.scatter_reduce(0, adj.rows[:, None].expand_as(s), s,
                               "amax")
    ex = torch.exp(s - mx[adj.rows])
    den = torch.zeros((adj.n, s.shape[1]), device=s.device,
                      dtype=s.dtype).index_add(0, adj.rows, ex)
    alpha = ex / den[adj.rows]
    return fault(_EdgeAgg.apply(alpha, v, adj))


def gat_forward(params, X, adj, heads=1, fault=_same):
    """Dot-product GAT: hidden layers concatenate ``heads`` heads, the
    last averages them; ReLU between layers."""
    h, L, n = X, len(params), X.shape[0]
    for i, layer in enumerate(params):
        split = lambda m: m.reshape(n, heads, -1)
        msg = gat_message(split(h @ layer["wq"]), split(h @ layer["wk"]),
                          split(h @ layer["wv"]), adj, fault=fault)
        if i < L - 1:
            h = torch.relu(msg.reshape(n, -1) + layer["b"])
        else:
            h = msg.mean(dim=1) + layer["b"]
    return h


def node_loss(logits, labels, mask):
    """Mean cross-entropy over the nodes where ``mask`` is 1."""
    ll = torch.log_softmax(logits, -1).gather(-1, labels[:, None])[:, 0]
    return -(ll * mask).sum() / mask.sum()


def forward(config, params, X, adj, fault=_same):
    if config["model"] == "gcn":
        return gcn_forward(params, X, adj, config.get("fused", True), fault)
    if config["model"] == "gat":
        return gat_forward(params, X, adj, config.get("heads", 1), fault)
    raise ValueError(f"no reference for model {config['model']!r}")


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
    gradients, the parameters after the last step), gradients and
    parameters as lists of dicts.  ``loss_fn`` and ``fault`` (applied to
    every aggregation's output) plant the faults that the comparison is
    shown to catch."""
    opt = config["adamw"]
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    wd = opt.get("weight_decay", 0.0)
    p = [{k: v.detach().clone().float() for k, v in layer.items()}
         for layer in params]
    m = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in p]
    s = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in p]
    losses, first = [], None
    with tf32(use_tf32):
        for t in range(1, steps + 1):
            leaves = [v.requires_grad_() for layer in p for v in layer.values()]
            loss = loss_fn(forward(config, p, X, adj, fault), labels, mask)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss.detach()))
            it = iter(grads)
            g = [{k: next(it) for k in layer} for layer in p]
            if first is None:
                first = [{k: v.detach().clone() for k, v in layer.items()}
                         for layer in g]
            b1c, b2c = 1.0 - b1 ** t, 1.0 - b2 ** t
            with torch.no_grad():
                for lp, lg, lm, ls in zip(p, g, m, s):
                    for k in lp:
                        lm[k] = b1 * lm[k] + (1 - b1) * lg[k]
                        ls[k] = b2 * ls[k] + (1 - b2) * lg[k] * lg[k]
                        upd = (lm[k] / b1c) / (torch.sqrt(ls[k] / b2c) + eps)
                        lp[k] = lp[k] - lr * (upd + wd * lp[k])
    p = [{k: v.detach() for k, v in layer.items()} for layer in p]
    return losses, first, p
