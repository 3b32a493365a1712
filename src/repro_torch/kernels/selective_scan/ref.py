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
