"""Oracles for the SDDMM kernels: ``sddmm_dense_ref`` is the definition
``(A≠0) ⊙ (Q·Kᵀ)``; ``sddmm_slots_ref`` replays the PCSR slot accounting
in a plain loop, so the packed ``(C, V, K)`` score tensor can be checked
slot for slot."""
from __future__ import annotations

import torch


def sddmm_slots_ref(pcsr, Q: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Per-slot raw scores ``(C, V, K)`` by direct slot traversal: the
    dot ``Q[row]·K[col]`` where the slot holds a stored value and the row
    is real, else 0."""
    cfg = pcsr.config
    V, R, Ks = cfg.V, cfg.R, pcsr.K
    Q = Q.to(torch.float32)
    K = K.to(torch.float32)
    out = torch.zeros((pcsr.num_chunks, V, Ks), dtype=torch.float32,
                      device=Q.device)
    for c in range(pcsr.num_chunks):
        for k in range(Ks):
            col = int(pcsr.colidx[c * Ks + k])
            base = int(pcsr.trow[c]) * R + int(pcsr.lrow[c * Ks + k]) * V
            for v in range(V):
                row = base + v
                if pcsr.vals[c, v, k] != 0 and row < pcsr.n_rows:
                    out[c, v, k] = Q[row] @ K[col]
    return out


def sddmm_dense_ref(A_dense, Q: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """The definition ``(A≠0) ⊙ (Q·Kᵀ)`` on dense tensors: E[i, j] =
    Q[i]·K[j] where A[i, j] ≠ 0, else 0."""
    A = torch.as_tensor(A_dense)
    scores = Q.to(torch.float32) @ K.to(torch.float32).T
    return torch.where(A != 0, scores, 0.0)
