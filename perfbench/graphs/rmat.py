"""R-MAT / Kronecker generator with the Graph500 parameters (A 0.57,
B = C 0.19): ``2**n_log2`` nodes, ``n·avg_deg/2`` edges drawn, made
symmetric, self loops and duplicates dropped.  A frozen copy of
``repro_torch.data.graphs.rmat`` (same draws for the same seed), so the
benchmark's graphs stay fixed whatever the program does to its own."""
from __future__ import annotations

import numpy as np

from perfbench.graphs._csr import symmetric_csr


def generate(seed: int, *, n_log2: int, avg_deg: int, a: float = 0.57,
             b: float = 0.19, c: float = 0.19):
    n = 1 << n_log2
    ne = n * avg_deg // 2
    rng = np.random.default_rng(seed)
    src = np.zeros(ne, np.int64)
    dst = np.zeros(ne, np.int64)
    for _ in range(n_log2):
        r = rng.random(ne)
        go_s = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        go_d = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src = src * 2 + go_s
        dst = dst * 2 + go_d
    indptr, indices = symmetric_csr(src, dst, n)
    return indptr, indices, n
