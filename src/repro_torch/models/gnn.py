"""GCN, GIN and GAT (paper §6.5) with pluggable sparse aggregation, and
the node-classification loss they train on.

The forwards take an ``spmm: (n, d) -> (n, d)`` closure over the graph.
Closures that also expose ``.fused(B, scale=, bias=, activation=,
residual=)`` get each GCN layer's bias + ReLU, and each GIN layer's
``(1+ε)h`` term, handed to the SpMM's fused epilogue — one kernel per
aggregation.  The fuse rules are the JAX package's, so the port launches
the same kernels in the same order.  GAT takes a ``gat_msg(Q, K, Vf)``
closure instead (two kernel launches per layer): dot-product attention
(``gat_forward``) or the published additive attention
(``gat_additive_forward``, Veličković et al., ICLR 2018).  Parameters are lists
of dicts of tensors; ``repro_torch.convert`` carries them over from numpy.
With differentiable closures (``core.engine``) the forwards train:
autograd runs every aggregation's backward in the kernels too.
"""
from __future__ import annotations

import inspect

import torch

from repro_torch.obs.trace import span


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
def init_gat(layer_dims, *, generator: torch.Generator, device="cpu",
             heads: int = 1, att_dim: int | None = None):
    """Dot-product attention GAT: per layer ``wq``/``wk`` project into the
    attention space (``att_dim`` per head, by default the per-head output
    dim) and ``wv`` transforms the message features.  With ``heads > 1``
    hidden layers concatenate the per-head outputs (their width must
    divide by ``heads``) and the last layer averages full-width heads."""
    params = []
    L = len(layer_dims) - 1
    for i in range(L):
        out = layer_dims[i + 1]
        concat = heads > 1 and i < L - 1
        if concat and out % heads:
            raise ValueError(f"layer dim {out} not divisible by {heads} heads")
        dv = out // heads if concat else out
        da = att_dim or dv
        params.append({
            "wq": _dense_init(layer_dims[i], heads * da, generator, device),
            "wk": _dense_init(layer_dims[i], heads * da, generator, device),
            "wv": _dense_init(layer_dims[i], heads * dv, generator, device),
            "b": torch.zeros(out, device=device),
        })
    return params


def gat_forward(params, X, gat_msg, heads: int = 1):
    """h'_i = Σ_j α_ij · (h_j·Wv), α = softmax_j(LeakyReLU(q_i·k_j/√d)),
    d the width of a head of q and k (``att_dim``), which may differ from
    the width of a head of Wv.

    ``gat_msg(Q, K, Vf)`` is the attention message
    (``core.engine.make_gat_message_fn``).  With ``heads > 1`` the
    projections are split into ``(H, n, d_head)`` stacks and handed to it
    as one batch, so every head runs in the same two kernel launches.
    The projections, bias and ReLU are plain tensor ops."""
    h = X
    L = len(params)
    for i, layer in enumerate(params):
        q, k, v = h @ layer["wq"], h @ layer["wk"], h @ layer["wv"]
        if heads == 1:
            h = gat_msg(q, k, v) + layer["b"]
        else:
            n = h.shape[0]
            split = lambda m: m.reshape(n, heads, -1).transpose(0, 1) \
                .contiguous()
            msg = gat_msg(split(q), split(k), split(v))    # (H, n, dv)
            if i < L - 1:                                  # concat heads
                h = msg.transpose(0, 1).reshape(n, -1) + layer["b"]
            else:                                          # average heads
                h = msg.mean(dim=0) + layer["b"]
        if i < L - 1:
            h = torch.relu(h)
    return h


# ------------------------------------------------------ GAT, additive
def gat_head_dims(layer_dims, heads):
    """Per-layer ``(H, F′)``: hidden layers concatenate ``heads[i]`` heads
    of ``width / heads[i]`` (the width must divide), the last averages
    ``heads[-1]`` heads of its full width."""
    L = len(layer_dims) - 1
    if len(heads) != L:
        raise ValueError(f"{len(heads)} head counts for {L} layers")
    out = []
    for i, H in enumerate(heads):
        width = layer_dims[i + 1]
        if i < L - 1 and width % H:
            raise ValueError(f"layer dim {width} not divisible by {H} heads")
        out.append((H, width // H if i < L - 1 else width))
    return out


def init_gat_additive(layer_dims, heads, *, generator: torch.Generator,
                      device="cpu"):
    """The published GAT's parameters: per layer ``w`` (d_in × H·F′), the
    attention vectors ``al`` and ``ar`` (H × F′) and a bias of the layer's
    output width, He-normal (``al``/``ar`` over fan-in F′) and zero."""
    params = []
    for i, (H, F) in enumerate(gat_head_dims(layer_dims, heads)):
        params.append({
            "w": _dense_init(layer_dims[i], H * F, generator, device),
            "al": _dense_init(F, H, generator, device).T.contiguous(),
            "ar": _dense_init(F, H, generator, device).T.contiguous(),
            "b": torch.zeros(layer_dims[i + 1], device=device),
        })
    return params


def additive_scores(wh, al, ar):
    """The message operands of additive attention: ``wh`` ``(n, H, F′)``
    gives ``el = wh·a_l`` and ``er = wh·a_r`` per head, and ``Q = [el, 1]``,
    ``K = [1, er]`` ``(H, n, 2)``, whose dot at scale 1 is ``el_i + er_j``:
    one rounding, as a plain add."""
    el = (wh * al).sum(-1).T                                   # (H, n)
    er = (wh * ar).sum(-1).T
    one = torch.ones_like(el)
    return (torch.stack([el, one], -1).contiguous(),
            torch.stack([one, er], -1).contiguous())


def gat_additive_forward(params, X, gat_msg, heads):
    """The published GAT: α = softmax_j(LeakyReLU(a_lᵀ W h_i + a_rᵀ W
    h_j)) over i's edges, the heads' ``Σ_j α_ij W h_j`` concatenated
    (hidden layers) or averaged (the last), plus a bias.  A hidden layer
    whose width is its input's (the PPI model's middle layer) adds that
    input, the identity skip, before the ELU.  ``gat_msg(Q, K, Vf)`` is
    the attention message at logit scale 1
    (``core.engine.make_gat_message_fn(..., scale=1)``); every head of a
    layer runs in its two launches."""
    h, L = X, len(params)
    for i, layer in enumerate(params):
        n, H = h.shape[0], layer["al"].shape[0]
        wh = (h @ layer["w"]).view(n, H, -1)                   # (n, H, F′)
        with span("gat.scores"):
            Q, K = additive_scores(wh, layer["al"], layer["ar"])
        msg = gat_msg(Q, K, wh.transpose(0, 1).contiguous())   # (H, n, F′)
        if i == L - 1:
            return msg.mean(dim=0) + layer["b"]
        out = msg.transpose(0, 1).reshape(n, -1) + layer["b"]
        if out.shape == h.shape:
            with span("gat.skip"):
                out = out + h
        h = torch.nn.functional.elu(out)
    return h


# ------------------------------------------------------------------- loss
def node_ce_loss(logits, labels, mask, total: float | None = None):
    """Cross-entropy summed over the nodes where ``mask`` is 1, over
    ``total`` (default: their count, the mean).  A row shard passes the
    global count, so the shards' losses add up to the mean."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels[:, None].long())[:, 0]
    if total is None:
        return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return -(ll * mask).sum() / max(total, 1.0)


def node_bce_loss(logits, labels, mask, total: float | None = None):
    """Sigmoid cross-entropy against multi-hot ``labels`` ``(n, C)``,
    summed over the nodes where ``mask`` is 1 and their C labels, over
    ``total`` (default: their count) times C: the mean per label."""
    per_node = torch.nn.functional.binary_cross_entropy_with_logits(
        logits, labels, reduction="none").sum(-1)
    count = torch.clamp_min(mask.sum(), 1.0) if total is None \
        else max(total, 1.0)
    return (per_node * mask).sum() / (count * labels.shape[-1])


def label_accuracy(logits, labels, mask):
    """Share of the (node, label) pairs of the nodes where ``mask`` is 1
    whose sign of the logit matches the multi-hot label."""
    right = ((logits > 0) == (labels > 0.5)).to(mask.dtype).mean(-1)
    return (right * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def accuracy(logits, labels, mask):
    """Share of the nodes where ``mask`` is 1 whose argmax is the label."""
    pred = logits.argmax(-1)
    return ((pred == labels).to(mask.dtype) * mask).sum() / \
        torch.clamp_min(mask.sum(), 1.0)
