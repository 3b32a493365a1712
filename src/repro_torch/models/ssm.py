"""The selective-SSM (Mamba-style) branch of Hymba's hybrid layers.

Prefill runs the recurrence through ``kernels.selective_scan``: its CUDA
kernel on the card, its plain version on the CPU.  The JAX package picks
between an XLA associative scan and its Pallas kernel with the
``ssm_backend`` perf option; both compute the same function, so the port
has no such option.  Decode is a single-step state update.  RWKV waits
for its family's slice (ROADMAP Queue 1 item 11b.4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import selective_scan


def mamba_defs(cfg) -> dict:
    L, D = cfg.n_layers, cfg.d_model
    Di = cfg.ssm_expand * D
    N = cfg.ssm_state
    return {
        "in_proj": ((L, D, 2 * Di), "col"),       # x and gate z
        "conv_w": ((L, 4, Di), "rep"),            # depthwise causal conv
        "dt_a": ((L, Di, 64), "rep"),             # low-rank Δ (mamba dt_rank)
        "dt_proj": ((L, 64, Di), "rep"),
        "dt_b": ((L, Di), "rep"),
        "bc_w": ((L, Di, 2 * N), "rep"),
        "a_log": ((L, Di, N), "rep"),
        "d_skip": ((L, Di), "rep"),
        "out_proj": ((L, Di, D), "row"),
    }


def _causal_conv(x, w):
    """x (B, S, Di), w (4, Di) depthwise: y_t = Σ_j w_j · x_{t-3+j}."""
    pads = F.pad(x, (0, 0, 3, 0))
    return sum(pads[:, j:j + x.shape[1]] * w[j] for j in range(4))


def mamba_branch(x, lp, cfg, *, conv_state=None, ssm_state=None):
    """x (B, S, D) → (B, S, D).  With states given (decode): S must be 1
    and ``(y, new_conv_state, new_ssm_state)`` is returned; the states are
    conv (B, 3, Di) in x's dtype and ssm (B, Di, N) float32."""
    B, S, D = x.shape
    Di = cfg.ssm_expand * D
    N = cfg.ssm_state
    xz = x @ lp["in_proj"]
    xi, z = xz[..., :Di], xz[..., Di:]
    decode = conv_state is not None
    if decode:
        window = torch.cat([conv_state, xi], dim=1)          # (B, 4, Di)
        xi = sum(window[:, j] * lp["conv_w"][j] for j in range(4))[:, None]
        new_conv = window[:, 1:]
    else:
        xi = _causal_conv(xi, lp["conv_w"])
    xi = F.silu(xi)
    dt = F.softplus((xi @ lp["dt_a"]) @ lp["dt_proj"] + lp["dt_b"])  # (B,S,Di)
    bc = xi @ lp["bc_w"]
    Bm, Cm = bc[..., :N], bc[..., N:]                        # (B, S, N)
    A = -torch.exp(lp["a_log"].float())                      # (Di, N)
    dt32, dtx32 = dt.float(), (dt * xi).float()
    if decode:
        dA = torch.exp(dt32[:, 0, :, None] * A)              # (B, Di, N)
        dBx = dtx32[:, 0, :, None] * Bm.float()[:, 0, None, :]
        h = dA * ssm_state + dBx
        y = (h * Cm.float()[:, 0, None, :]).sum(-1)[:, None]
    else:
        # built directly in the scan's (B, S, N, Di) layout: the same
        # products as the reference's (B, S, Di, N) ones and its transpose
        dA = (dt32[:, :, None, :] * A.T).exp_()   # in place: S·N·Di f32
        dBx = dtx32[:, :, None, :] * Bm.float()[..., None]
        y = selective_scan(dA, dBx, Cm.float())
    y = y.to(x.dtype) + xi * lp["d_skip"]
    y = (y * F.silu(z)) @ lp["out_proj"]
    if decode:
        return y, new_conv, h
    return y
