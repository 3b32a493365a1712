"""Distributed GAT message: the joint K/Vf halo exchange, then the
single-device two-kernel message on each rank's shard.

The single-device GAT message (``core.engine.make_gat_message_fn``) is
the fused SDDMM→softmax-stats kernel feeding the ParamSpMM softmax
prologue forward, and a flash-recompute backward of the raw SDDMM (dα)
and three ParamSpMMs (dQ on A, dK and dVf on Aᵀ).  A rank runs exactly
that on its shard's PCSR over the extended column space:

* **forward** — K and Vf are exchanged *jointly*: one ``all_gather`` of
  ``[K | Vf]`` (heads merged into the feature axis, ``(rows_pad, H·(dk +
  dv))``) serves every head of both operands.  Then Q (local rows) and
  the extended K, Vf go through the message: two kernel launches per
  rank, α never written out.
* **backward** — the message's own backward gives dQ and dK, dVf over
  the extended space; the exchange's backward scatters their halo blocks
  home in one ``reduce_scatter`` (the gradients travel concatenated, as
  the operands did).  No plain fallback: on the card every step is a
  kernel or a collective.

Row partitioning keeps every destination row's edges on one shard, so
the softmax, forward stats and backward vjp alike, never communicates.
"""
from __future__ import annotations

import torch

from .halo import halo_exchange


def head_split(x2, H: int):
    """``(n, H·d)`` merged layout → ``(H, n, d)`` head stack."""
    n = x2.shape[0]
    return x2.reshape(n, H, -1).transpose(0, 1).contiguous()


def head_merge(x3):
    """``(H, n, d)`` head stack → ``(n, H·d)`` merged layout."""
    H, n, d = x3.shape
    return x3.transpose(0, 1).reshape(n, H * d)


def _message_fn(g, slope: float):
    """The shard's differentiable GAT message, cached per slope."""
    if slope not in g._gat_fns:
        from repro_torch.core.engine import make_gat_message_fn
        op = g.pack.op
        g._gat_fns[slope] = make_gat_message_fn(op.pcsr, op.pcsr_t,
                                                slope=slope)
    return g._gat_fns[slope]


def dist_gat(g, Q, K, Vf, *, slope: float = 0.2):
    """The GAT message on ``g``'s rank: ``Q``, ``K``, ``Vf`` are this
    rank's ``(rows_pad, d)`` blocks, or ``(H, rows_pad, d)`` head stacks
    (every head in the same launches); returns the same layout."""
    multi = Q.ndim == 3
    if multi:
        H = Q.shape[0]
        merged = torch.cat([head_merge(K), head_merge(Vf)], dim=1)
        wk = H * K.shape[-1]
        halo = halo_exchange(merged, g.halo_plan)
        k_ext = torch.cat([K, head_split(halo[:, :wk], H)], dim=1)
        vf_ext = torch.cat([Vf, head_split(halo[:, wk:], H)], dim=1)
    else:
        wk = K.shape[-1]
        halo = halo_exchange(torch.cat([K, Vf], dim=1), g.halo_plan)
        k_ext = torch.cat([K, halo[:, :wk]], dim=0)
        vf_ext = torch.cat([Vf, halo[:, wk:]], dim=0)
    return _message_fn(g, slope)(Q.contiguous(), k_ext.contiguous(),
                                 vf_ext.contiguous())
