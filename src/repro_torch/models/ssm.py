"""SSM families: the selective-SSM (Mamba-style) branch of Hymba's hybrid
layers, and RWKV6 "Finch" (linear attention with a data-dependent
decay).

Mamba's prefill runs the recurrence through ``kernels.selective_scan``:
its CUDA kernel on the card, its plain version on the CPU.  The JAX
package picks between an XLA associative scan and its Pallas kernel with
the ``ssm_backend`` perf option; both compute the same function, so the
device picks here, and the option takes only ``"xla"`` (``"pallas"``
raises).  The ``ssm_scan_dtype`` option (float32 or bfloat16) is the
dtype A, dA and dBx are built and rounded in, as the reference builds
them; the recurrence itself runs in float32 either way, on the operands
cast back: the reference's Pallas route, which casts them to float32
before its float32 kernel (its default XLA route combines them in the
option's dtype instead).  Decode casts the step's dA and dBx to float32
as the reference does, and the state stays float32.  On a mesh the
scan's operands are pinned to batch over data and Di over model
(``sharding_ctx.constrain_scan``), so each rank launches the kernel on
its own block; the input projection's output is first gathered whole
over model (``constrain_whole``), since it is split into x and the gate
along its model-sharded feature dim.  RWKV's
recurrence is a loop over time in plain PyTorch (the reference's
``lax.scan``; no Pallas kernel there); on a mesh each rank runs it on
its own (batch, heads) block (``sharding_ctx.per_rank``).  Decode is a
single-step state update in both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import selective_scan
from .common import apply_norm, perf_option
from .sharding_ctx import (constrain_ff, constrain_scan, constrain_whole,
                           pad_seq, per_rank)


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
    pads = pad_seq(x, 3)
    return sum(pads[:, j:j + x.shape[1]] * w[j] for j in range(4))


def mamba_branch(x, lp, cfg, *, conv_state=None, ssm_state=None):
    """x (B, S, D) → (B, S, D).  With states given (decode): S must be 1
    and ``(y, new_conv_state, new_ssm_state)`` is returned; the states are
    conv (B, 3, Di) in x's dtype and ssm (B, Di, N) float32."""
    B, S, D = x.shape
    Di = cfg.ssm_expand * D
    N = cfg.ssm_state
    xz = constrain_whole(x @ lp["in_proj"])
    xi, z = xz[..., :Di], xz[..., Di:]
    decode = conv_state is not None
    if decode:
        window = torch.cat([conv_state, xi], dim=1)          # (B, 4, Di)
        xi = sum(window[:, j] * lp["conv_w"][j] for j in range(4))[:, None]
        new_conv = window[:, 1:]
    else:
        xi = _causal_conv(xi, lp["conv_w"])
    xi = F.silu(xi)
    # on a mesh: the low-rank Δ and B|C (64 and 2N wide) reduced whole,
    # Δ then cut over Di (the identity elsewhere)
    dt = constrain_ff(F.softplus(constrain_whole(xi @ lp["dt_a"])
                                 @ lp["dt_proj"] + lp["dt_b"]))  # (B,S,Di)
    bc = constrain_whole(xi @ lp["bc_w"])
    Bm, Cm = bc[..., :N], bc[..., N:]                        # (B, S, N)
    # A, dA and dBx rounded in the scan dtype (the identity in float32),
    # each cast to float32 as soon as it is built, so that no bf16
    # operand outlives its float32 copy
    sdt = getattr(torch, perf_option("ssm_scan_dtype"))
    A = (-torch.exp(lp["a_log"].float())).to(sdt)            # (Di, N)
    dts, dtxs, Bs = dt.to(sdt), (dt * xi).to(sdt), Bm.to(sdt)
    if decode:
        dA = torch.exp(dts[:, 0, :, None] * A).float()       # (B, Di, N)
        dBx = (dtxs[:, 0, :, None] * Bs[:, 0, None, :]).float()
        h = dA * ssm_state + dBx
        y = (h * Cm.float()[:, 0, None, :]).sum(-1)[:, None]
    else:
        # built directly in the scan's (B, S, N, Di) layout: the same
        # products as the reference's (B, S, Di, N) ones and its transpose
        dA = (dts[:, :, None, :] * A.T).exp_().float()   # exp in place
        dBx = (dtxs[:, :, None, :] * Bs[..., None]).float()
        y = selective_scan(*constrain_scan(dA, dBx, Cm.float()))
    y = y.to(x.dtype) + xi * lp["d_skip"]
    y = (y * F.silu(z)) @ lp["out_proj"]
    if decode:
        return y, new_conv, h
    return y


# ------------------------------------------------------------------ RWKV6
RWKV_HEAD_DIM = 64


def rwkv_defs(cfg) -> dict:
    L, D, FF = cfg.n_layers, cfg.d_model, cfg.d_ff
    lora = 64
    return {
        "ln1": {"w": ((L, D), "rep"), "b": ((L, D), "rep")},
        "ln2": {"w": ((L, D), "rep"), "b": ((L, D), "rep")},
        # time mix: token-shift interpolation weights per r/k/v/w/g
        "mu": ((L, 5, D), "rep"),
        "wr": ((L, D, D), "col"),
        "wk": ((L, D, D), "col"),
        "wv": ((L, D, D), "col"),
        "wg": ((L, D, D), "col"),
        # data-dependent decay (Finch): low-rank w = exp(-exp(lora(x)))
        "w_lora_a": ((L, D, lora), "rep"),
        "w_lora_b": ((L, lora, D), "rep"),
        "w_bias": ((L, D), "rep"),
        "u_bonus": ((L, D), "rep"),
        "wo": ((L, D, D), "row"),
        # channel mix
        "cm_mu": ((L, 2, D), "rep"),
        "cm_k": ((L, D, FF), "col"),
        "cm_v": ((L, FF, D), "row"),
        "cm_r": ((L, D, D), "col"),
    }


def _token_shift(x, last=None):
    """x (B, S, D) → the previous token's x (zeros before the first);
    ``last`` (B, 1, D) is returned as it is (decode)."""
    if last is not None:
        return last
    return pad_seq(x, 1)[:, :-1]


def _wkv6(r, k, v, w, u, state=None):
    """RWKV6's core over r/k/v/w (B, S, H, hd) and u (H, hd), in float32:
    S_t = diag(w_t)·S_{t−1} + k_t v_tᵀ and
    y_t = r_t·(S_{t−1} + diag(u) k_t v_tᵀ).
    ``state`` (B, H, hd, hd) float32 is S_0 (zeros if None); returns (y
    (B, S, H, hd) float32, S_S).

    The bonus term r_t·diag(u) k_t v_tᵀ = (Σ r_t u k_t) v_t is formed for
    every t at once, so the loop over time runs three kernels a step (the
    product with S_{t−1}, the decay, the rank-1 update); the sums round
    apart from the reference's by float32 ulps."""
    B, S, H, hd = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, w))
    bonus = (r * u.float() * k).sum(-1, keepdim=True) * v     # (B,S,H,hd)
    # (S, B·H, ·, ·) layouts: row vectors of r and v, columns of k and w
    rows = lambda a: a.transpose(0, 1).reshape(S, B * H, 1, hd)
    cols = lambda a: a.transpose(0, 1).reshape(S, B * H, hd, 1)
    rt, vt, kt, wt = rows(r), rows(v), cols(k), cols(w)
    s = (torch.zeros(B * H, hd, hd, dtype=torch.float32, device=r.device)
         if state is None else state.reshape(B * H, hd, hd))
    ys = []
    for t in range(S):
        ys.append(torch.bmm(rt[t], s))
        s = torch.baddbmm(s * wt[t], kt[t], vt[t])
    y = torch.stack(ys).reshape(S, B, H, hd).transpose(0, 1) + bonus
    return y, s.reshape(B, H, hd, hd)


def rwkv_time_mix(x, lp, *, last=None, state=None):
    """x (B, S, D) → (out (B, S, D), the WKV state after the last step).
    The decay's low-rank product is in x's dtype, its two exps in
    float32; the WKV's y comes back in float32 and is cast to x's dtype
    before the gate, as in the reference."""
    B, S, D = x.shape
    H = D // RWKV_HEAD_DIM
    xp = _token_shift(x, last)
    mixed = [x + lp["mu"][i] * (xp - x) for i in range(5)]
    r = (mixed[0] @ lp["wr"]).reshape(B, S, H, RWKV_HEAD_DIM)
    k = (mixed[1] @ lp["wk"]).reshape(B, S, H, RWKV_HEAD_DIM)
    v = (mixed[2] @ lp["wv"]).reshape(B, S, H, RWKV_HEAD_DIM)
    g = F.silu(mixed[4] @ lp["wg"])
    wdec = lp["w_bias"] + (torch.tanh(mixed[3] @ lp["w_lora_a"])
                           @ lp["w_lora_b"])
    w = torch.exp(-torch.exp(wdec.float())).reshape(B, S, H, RWKV_HEAD_DIM)
    u = lp["u_bonus"].reshape(H, RWKV_HEAD_DIM)
    y, new_state = per_rank(
        _wkv6, (r, k, v, w, u, state),
        ((0, 2),) * 4 + ((None, 0), None if state is None else (0, 1)),
        ((0, 2), (0, 1)))
    y = y.to(x.dtype).reshape(B, S, D) * g
    return y @ lp["wo"], new_state


def rwkv_channel_mix(x, lp, *, last=None):
    xp = _token_shift(x, last)
    xk = x + lp["cm_mu"][0] * (xp - x)
    xr = x + lp["cm_mu"][1] * (xp - x)
    k = torch.square(F.relu(xk @ lp["cm_k"]))
    return torch.sigmoid(xr @ lp["cm_r"]) * (k @ lp["cm_v"])


def rwkv_layer(x, lp, *, states=None):
    """One RWKV6 block.  ``states = (last1, wkv, last2)`` → decode (S = 1):
    the two mixes' previous normed inputs (B, 1, D) and the WKV state
    (B, H, hd, hd) float32; returns (x, (h, new_wkv, h2)), the new
    states, which are the mixes' normed inputs (not the residual
    stream).  Else (x, None)."""
    h = apply_norm(x, lp["ln1"], "layernorm")
    if states is None:
        att, _ = rwkv_time_mix(h, lp)
        x = x + att
        h2 = apply_norm(x, lp["ln2"], "layernorm")
        return x + rwkv_channel_mix(h2, lp), None
    last1, wkv, last2 = states
    att, new_wkv = rwkv_time_mix(h, lp, last=last1, state=wkv)
    x = x + att
    h2 = apply_norm(x, lp["ln2"], "layernorm")
    x = x + rwkv_channel_mix(h2, lp, last=last2)
    return x, (h, new_wkv, h2)
