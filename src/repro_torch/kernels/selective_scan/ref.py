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


selective_scan_ref = selective_scan_plain     # the reference's name


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


def selective_scan_chunk_states_plain(dA, dBx, T):
    """The hidden state at the end of every chunk of ``T`` steps, ``(B,
    ⌈S/T⌉, N, Di)``: ``states[:, k] = h_{min(T(k+1), S) − 1}``, what the
    training forward keeps for the backward."""
    B, S, N, Di = dA.shape
    h = dA.new_zeros((B, N, Di))
    states = dA.new_empty((B, -(-S // T), N, Di))
    for t in range(S):
        h = dA[:, t] * h + dBx[:, t]
        if (t + 1) % T == 0 or t == S - 1:
            states[:, t // T] = h
    return states


def selective_scan_backward_from_states_plain(dA, dBx, C, states, gy, T):
    """``selective_scan_backward_plain`` from the chunk states of
    ``selective_scan_chunk_states_plain(dA, dBx, T)`` in place of every
    hidden state: each chunk's h_t rebuilt from the state at the end of
    the chunk before it (0 before the first), with the recurrence's own
    arithmetic, so on the plain version's states it gives that function's
    bits."""
    B, S, N, Di = dA.shape
    h = torch.empty_like(dA)
    for k in range(states.shape[1]):
        hk = states[:, k - 1] if k else dA.new_zeros((B, N, Di))
        for t in range(k * T, min((k + 1) * T, S)):
            hk = dA[:, t] * hk + dBx[:, t]
            h[:, t] = hk
    return selective_scan_backward_plain(dA, C, h, gy)
