"""Random k-regular graph: ``k/2`` random permutations, each node joined
to the next in each, made symmetric, self loops and duplicates dropped
(degrees k, a few k − 1 or k − 2 where two draws coincide).  A frozen copy
of ``repro_torch.data.graphs.kregular`` (same draws for the same seed)."""
from __future__ import annotations

import numpy as np

from perfbench.graphs._csr import symmetric_csr


def generate(seed: int, *, n: int, k: int):
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for _ in range(k // 2):
        perm = rng.permutation(n)
        src.append(perm)
        dst.append(np.roll(perm, 1))
    indptr, indices = symmetric_csr(np.concatenate(src),
                                    np.concatenate(dst), n)
    return indptr, indices, n
