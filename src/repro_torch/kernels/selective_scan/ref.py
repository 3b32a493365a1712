"""The selective scan's plain PyTorch version: the oracle the CPU path
runs and the card's kernel is held against."""
from __future__ import annotations

import torch


def selective_scan_plain(dA, dBx, C):
    """dA/dBx ``(B, S, N, Di)`` float32, C ``(B, S, N)`` → y ``(B, S, Di)``
    float32, as a loop over time on any device:

        h_t = dA_t ⊙ h_{t−1} + dBx_t        (h_{−1} = 0)
        y_t = Σ_n h_t[n, :] · C_t[n]
    """
    B, S, N, Di = dA.shape
    h = dA.new_zeros((B, N, Di))
    y = dA.new_empty((B, S, Di))
    for t in range(S):
        h = dA[:, t] * h + dBx[:, t]
        y[:, t] = (h * C[:, t, :, None]).sum(1)
    return y


def selective_scan_states_plain(dA, dBx):
    """Every hidden state ``h (B, S, N, Di)`` of the recurrence above."""
    h = dA.new_zeros(dA.shape[:1] + dA.shape[2:])
    hs = torch.empty_like(dA)
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        hs[:, t] = h
    return hs


def selective_scan_backward_plain(dA, C, h, gy):
    """The scan's gradient as a loop backwards over time: dA and the
    hidden states h ``(B, S, N, Di)``, C ``(B, S, N)`` and the output's
    cotangent gy ``(B, S, Di)``, float32 → ``(g_dA, g_dBx, g_C)``:

        gh_t     = gy_t · C_t + dA_{t+1} ⊙ gh_{t+1}      (gh_S = 0)
        g_dBx_t  = gh_t
        g_dA_t   = gh_t ⊙ h_{t−1}                        (h_{−1} = 0)
        g_C_t[n] = Σ_d gy_t[d] · h_t[n, d]
    """
    B, S, N, Di = dA.shape
    g_dA = torch.empty_like(dA)
    g_dBx = torch.empty_like(dA)
    g_C = dA.new_empty((B, S, N))
    gh = dA.new_zeros((B, N, Di))
    for t in range(S - 1, -1, -1):
        gy_t = gy[:, t, None, :]                              # (B, 1, Di)
        nxt = dA[:, t + 1] * gh if t + 1 < S else 0.0
        gh = gy_t * C[:, t, :, None] + nxt
        g_dBx[:, t] = gh
        g_dA[:, t] = gh * h[:, t - 1] if t > 0 else 0.0
        g_C[:, t] = (gy_t * h[:, t]).sum(-1)
    return g_dA, g_dBx, g_C
