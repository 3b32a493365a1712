"""AdamW as plain functions on parameters held as lists of dicts of
tensors (the models' layout), with float32 state.

The arithmetic is the JAX package's, step for step: bias corrections
``b1c = 1 − b1^t`` and ``b2c = 1 − b2^t`` in float32, ``vh = v / b2c``
and the update ``p − lr·(mh / (√vh + eps) + wd·p)``.  ``torch.optim.AdamW``
divides ``√v`` by ``√b2c`` and applies the decay first, so its
trajectories drift from the reference's; it is not used.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0     # global-norm clip; 0 disables


def adamw_init(params):
    """Zero moments shaped like ``params`` and step 0."""
    zeros = lambda layer: {k: torch.zeros_like(v, dtype=torch.float32)
                           for k, v in layer.items()}
    return {"m": [zeros(l) for l in params], "v": [zeros(l) for l in params],
            "step": 0}


def global_norm(grads):
    """√(Σ g²) over every tensor of a list of dicts, in float32, summed
    in the reference's leaf order (layers in turn, keys sorted)."""
    return torch.sqrt(sum(torch.sum(torch.square(layer[k].float()))
                          for layer in grads for k in sorted(layer)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step: returns ``(new_params, new_state)``; the inputs are
    left as they are.  New parameters are detached tensors of the old
    ones' dtype."""
    step = state["step"] + 1
    if cfg.grad_clip > 0:
        gn = global_norm(grads)
        clip = torch.clamp_max(cfg.grad_clip / (gn + 1e-9), 1.0)
        grads = [{k: g * clip for k, g in layer.items()} for layer in grads]
    # the bias corrections in float32, as tensors on the parameters'
    # device: CUDA divides by a host scalar through its reciprocal, which
    # rounds differently from the reference's division
    one = np.float32(1.0)
    device = next(iter(params[0].values())).device
    b1c, b2c = (torch.tensor(one - np.float32(b) ** np.float32(step),
                             device=device) for b in (cfg.b1, cfg.b2))
    new_p, new_m, new_v = [], [], []
    for p_l, g_l, m_l, v_l in zip(params, grads, state["m"], state["v"]):
        lp, lm, lv = {}, {}, {}
        for k, p in p_l.items():
            g = g_l[k].float()
            m = cfg.b1 * m_l[k] + (1 - cfg.b1) * g
            v = cfg.b2 * v_l[k] + (1 - cfg.b2) * g * g
            mh = m / b1c
            vh = v / b2c
            p32 = p.float()
            p32 = p32 - cfg.lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                  + cfg.weight_decay * p32)
            lp[k], lm[k], lv[k] = p32.to(p.dtype), m, v
        new_p.append(lp)
        new_m.append(lm)
        new_v.append(lv)
    return new_p, {"m": new_m, "v": new_v, "step": step}
