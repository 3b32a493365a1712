"""Edge lists to canonical CSR, for the generators (plain numpy)."""
from __future__ import annotations

import numpy as np


def symmetric_csr(src, dst, n: int):
    """Drop self loops, add each edge's reverse, sort by (row, column)
    and drop duplicates: ``(indptr, indices)``, int64."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = np.concatenate([src * n + dst, dst * n + src])
    key.sort()        # not np.unique: numpy 2.3's is a slow hash path
    key = key[np.concatenate([[True], key[1:] != key[:-1]])]
    rows, cols = key // n, key % n
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, cols.astype(np.int64)
