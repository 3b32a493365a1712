"""Sparse-matrix features for the SpMM-decider (paper Table 3).

Three categories: size (n, n̂, nnz, r, d, d̂, d_max), degree distribution
(CV, ĈV, SR_i, bal_i), data locality (ρ, bw_avg, bw_max, PR_i).  Features
are a function of the sparse matrix only — measured once, reused across
``dim`` (the paper's amortization argument).  ``dim`` itself is appended
at prediction time so one model serves all dims.

``bal_1``/``bal_2`` are the balanced-schedule slot savings — the fraction
of grid slots the ``B=True`` layout removes relative to the mean-SG
split layout at V=1/V=2 — the direct predictor of when the decider
should pick a balanced config (high CV ⇒ high bal_i).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .pcsr import pcsr_stats
from .sparse import CSRMatrix

FEATURE_NAMES = [
    "n", "n_hat", "nnz", "r", "d", "d_hat", "d_max",          # size
    "cv", "cv_hat", "sr_1", "sr_2",                           # degree dist
    "rho", "bw_avg", "bw_max", "pr_1", "pr_2",                # locality
    "bal_1", "bal_2",                     # balanced-schedule slot savings
]


@dataclass
class MatrixFeatures:
    values: np.ndarray          # (len(FEATURE_NAMES),) float64

    def as_dict(self):
        return dict(zip(FEATURE_NAMES, self.values.tolist()))

    def vector(self, dim: int | None = None) -> np.ndarray:
        """Feature vector for the decider; log-compress the size features
        so forests split on relative rather than absolute scale."""
        v = self.values.copy()
        for i in (0, 1, 2, 4, 5, 6, 12, 13):    # n, n̂, nnz, d, d̂, dmax, bw
            v[i] = np.log1p(v[i])
        if dim is not None:
            v = np.concatenate([v, [float(dim)]])
        return v


def _split_ratio(csr: CSRMatrix, V: int) -> float:
    """SR under ⟨V, S=True⟩ (paper Eq. 4), at the reference W = 8/V."""
    st = pcsr_stats(csr.indptr, csr.indices, csr.n_rows, csr.n_cols,
                    V, max(1, 8 // V))
    C, _, _ = st.chunks_and_slots(S=True)
    return C / max(1, st.n_nonempty_blocks)


def _balanced_gain(csr: CSRMatrix, V: int) -> float:
    """Slot savings of the ⟨V, S=True, B=True⟩ layout over ⟨V, S=True⟩ at
    the reference W = 8/V: ``1 − slots_B/slots_S``.  ≈ 0 on uniform-degree
    graphs (the capacity search lands on the mean-SG layout), grows with
    degree CV — the feature the decider splits on to pick ``B``."""
    st = pcsr_stats(csr.indptr, csr.indices, csr.n_rows, csr.n_cols,
                    V, max(1, 8 // V))
    _, _, slots_s = st.chunks_and_slots(S=True)
    _, _, slots_b = st.chunks_and_slots(S=True, B=True)
    return 1.0 - slots_b / max(1, slots_s)


def extract_features(csr: CSRMatrix) -> MatrixFeatures:
    n = csr.n_rows
    deg = csr.degrees.astype(np.float64)
    nnz = csr.nnz
    n_hat = int((deg > 0).sum())
    d = nnz / max(1, n)
    d_hat = nnz / max(1, n_hat)
    d_max = float(deg.max()) if n else 0.0
    cv = float(deg.std() / d) if d > 0 else 0.0
    deg_ne = deg[deg > 0]
    cv_hat = float(deg_ne.std() / d_hat) if n_hat else 0.0
    rho = nnz / max(1, n * csr.n_cols)
    # row bandwidth: last col − first col per non-empty row
    if nnz:
        starts = csr.indptr[:-1][deg > 0]
        ends = csr.indptr[1:][deg > 0] - 1
        bw = (csr.indices[ends] - csr.indices[starts]).astype(np.float64)
        bw_avg, bw_max = float(bw.mean()), float(bw.max())
    else:
        bw_avg = bw_max = 0.0
    st2 = pcsr_stats(csr.indptr, csr.indices, csr.n_rows, csr.n_cols, 2, 4)
    pr_2 = st2.padding_ratio
    vals = np.array([n, n_hat, nnz, n_hat / max(1, n), d, d_hat, d_max,
                     cv, cv_hat, _split_ratio(csr, 1), _split_ratio(csr, 2),
                     rho, bw_avg, bw_max, 0.0, pr_2,
                     _balanced_gain(csr, 1), _balanced_gain(csr, 2)],
                    np.float64)
    return MatrixFeatures(vals)
