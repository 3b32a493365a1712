"""AdamW as plain functions on parameter trees of tensors, with float32
state: a list of dicts (the GNN models' layout) or nested dicts (the LM
side's), any nesting of dicts, lists and tuples.

The arithmetic is the JAX package's, step for step: bias corrections
``b1c = 1 − b1^t`` and ``b2c = 1 − b2^t`` in float32, ``vh = v / b2c``
and the update ``p − lr·(mh / (√vh + eps) + wd·p)``.  ``torch.optim.AdamW``
divides ``√v`` by ``√b2c`` and applies the decay first, so its
trajectories drift from the reference's; it is not used.  Leaves are taken
in ``jax.tree.leaves`` order (list items in turn, dict keys sorted at
every level), which sets the global norm's summation order.

Leaves may be DTensors (the LM mesh path, ``launch/steps.py``): the
global norm is one norm over every shard (each leaf's sum of squares is
reduced over the mesh), and each moment keeps its own placements, the
parameter's or, under ZeRO-1, those with the data axis added.  The
update runs on each rank's shard of the moments, the gradient and the
parameter taken to the moments' placements; a ZeRO-1 parameter is then
gathered back to its own placements.  Every element's arithmetic is the
same either way, so ZeRO-1 gives the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.tensor import DTensor


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``;
    returns ``tree``'s nesting (dicts keep their key order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


INPLACE_PIECE = 1 << 24     # elements a piece of an in-place update


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0     # global-norm clip; 0 disables


def adamw_init(params):
    """Zero moments shaped (and placed) like ``params`` and step 0."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": 0}


def global_norm(tree):
    """√(Σ g²) over every tensor of a tree, in float32, summed in the
    reference's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, *, inplace=False):
    """One AdamW step: returns ``(new_params, new_state)``.  New parameters
    are detached tensors of the old ones' dtype, and the inputs are left
    as they are, unless ``inplace``: then ``grads`` are clipped, and the
    parameters and moments updated, in place (the caller gives them up,
    as the reference's jitted step donates them), in pieces of at most
    ``INPLACE_PIECE`` elements of each (contiguous) leaf's flat view, so a
    step holds one copy of the state and float32 temporaries of one
    piece.  The update is elementwise, so the bits are the same either
    way."""
    step = state["step"] + 1
    if cfg.grad_clip > 0:
        gn = global_norm(grads)
        clip = torch.clamp_max(cfg.grad_clip / (gn + 1e-9), 1.0)
        grads = tree_map((lambda g: g.mul_(clip)) if inplace
                         else (lambda g: g * clip), grads)
    # the bias corrections in float32, as tensors on the parameters'
    # device: CUDA divides by a host scalar through its reciprocal, which
    # rounds differently from the reference's division
    one = np.float32(1.0)
    first = tree_leaves(params)[0]
    device = (first.to_local() if isinstance(first, DTensor) else first).device
    b1c, b2c = (torch.tensor(one - np.float32(b) ** np.float32(step),
                             device=device) for b in (cfg.b1, cfg.b2))

    def upd(p, g, m, v):
        g = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        p32 = p.float()
        p32 = p32 - cfg.lr * (mh / (torch.sqrt(vh) + cfg.eps)
                              + cfg.weight_decay * p32)
        return p32.to(p.dtype), m, v

    def upd_local(p, g, m, v):
        for part in zip(*(t.view(-1).split(INPLACE_PIECE)
                          for t in (p, g, m, v))):
            new = upd(*part)
            for dst, src in zip(part[:1] + part[2:], new):
                dst.copy_(src)

    def upd_(p, g, m, v):
        if not isinstance(p, DTensor):
            upd_local(p, g, m, v)
            return p, m, v
        mesh, place = m.device_mesh, m.placements
        g = g.redistribute(mesh, place).to_local().contiguous()
        if p.placements == place:
            upd_local(p.to_local(), g, m.to_local(), v.to_local())
            return p, m, v
        pz = p.redistribute(mesh, place)          # a local cut of p
        pl = pz.to_local().contiguous()
        upd_local(pl, g, m.to_local(), v.to_local())
        new = DTensor.from_local(pl, mesh, place, run_check=False,
                                 shape=p.shape, stride=p.stride())
        p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())
        return p, m, v

    out = tree_map(upd_ if inplace else upd, params, grads, state["m"],
                   state["v"])
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}
