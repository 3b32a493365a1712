"""Minimal host-side CSR container (numpy, the packer's input format)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRMatrix:
    indptr: np.ndarray     # (n_rows+1,) int64
    indices: np.ndarray    # (nnz,) int64, column ids
    data: np.ndarray       # (nnz,) float32
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @staticmethod
    def from_coo(rows, cols, vals, n_rows, n_cols,
                 sum_duplicates=True) -> "CSRMatrix":
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float32)
        key = rows * n_cols + cols
        order = np.argsort(key, kind="stable")
        key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
        if sum_duplicates and key.shape[0]:
            uniq, start = np.unique(key, return_index=True)
            seg = np.repeat(np.arange(uniq.shape[0]), np.diff(
                np.concatenate([start, [key.shape[0]]])))
            summed = np.zeros(uniq.shape[0], np.float32)
            np.add.at(summed, seg, vals)
            rows, cols, vals = uniq // n_cols, uniq % n_cols, summed
        counts = np.bincount(rows, minlength=n_rows)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return CSRMatrix(indptr, cols.astype(np.int64), vals, n_rows, n_cols)

    @staticmethod
    def from_dense(A) -> "CSRMatrix":
        A = np.asarray(A)
        rows, cols = np.nonzero(A)
        return CSRMatrix.from_coo(rows, cols, A[rows, cols].astype(np.float32),
                                  A.shape[0], A.shape[1], sum_duplicates=False)

    @staticmethod
    def from_edges(src, dst, n, vals=None, symmetrize=False) -> "CSRMatrix":
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if vals is None:
            vals = np.ones(src.shape[0], np.float32)
        return CSRMatrix.from_coo(src, dst, vals, n, n)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, np.float32)
        rows = np.repeat(np.arange(self.n_rows), self.degrees)
        out[rows, self.indices] = self.data
        return out

    def transpose(self) -> "CSRMatrix":
        from .pcsr import transpose_csr
        ip, ix, d, nr, nc = transpose_csr(self.indptr, self.indices,
                                          self.data, self.n_rows, self.n_cols)
        return CSRMatrix(ip, ix, d, nr, nc)

    def permute(self, perm: np.ndarray) -> "CSRMatrix":
        """Symmetric permutation A' = P A Pᵀ: node i → position perm[i]."""
        if self.n_rows != self.n_cols:
            raise ValueError("permute needs a square matrix")
        rows = np.repeat(np.arange(self.n_rows), self.degrees)
        return CSRMatrix.from_coo(perm[rows], perm[self.indices], self.data,
                                  self.n_rows, self.n_cols,
                                  sum_duplicates=False)

    def row_normalize(self) -> "CSRMatrix":
        """D⁻¹A: each row's values over its degree (at least 1)."""
        deg = np.maximum(self.degrees, 1).astype(np.float32)
        rows = np.repeat(np.arange(self.n_rows), self.degrees)
        return CSRMatrix(self.indptr, self.indices,
                         (self.data / deg[rows]).astype(np.float32),
                         self.n_rows, self.n_cols)

    def gcn_normalize(self) -> "CSRMatrix":
        """Â = D^{-1/2}(A+I)D^{-1/2} (GCN propagation matrix)."""
        if self.n_rows != self.n_cols:
            raise ValueError("gcn_normalize needs a square matrix")
        rows = np.repeat(np.arange(self.n_rows), self.degrees)
        rows = np.concatenate([rows, np.arange(self.n_rows)])
        cols = np.concatenate([self.indices, np.arange(self.n_rows)])
        vals = np.concatenate([self.data, np.ones(self.n_rows, np.float32)])
        m = CSRMatrix.from_coo(rows, cols, vals, self.n_rows, self.n_cols)
        deg = np.maximum(np.diff(m.indptr), 1).astype(np.float32)
        dinv = 1.0 / np.sqrt(deg)
        r2 = np.repeat(np.arange(m.n_rows), np.diff(m.indptr))
        return CSRMatrix(m.indptr, m.indices,
                         (m.data * dinv[r2] * dinv[m.indices]).astype(np.float32),
                         m.n_rows, m.n_cols)
