"""Graph reordering to enhance data locality (paper §4.4), on the host.

The paper preprocesses with Rabbit Reordering (community detection +
locality-aware ID assignment): nodes with shared neighbours get close
IDs, which gives consecutive same-column nonzeros for V=2 blocking (lower
PR_2).  ``rabbit_reorder`` plays that role with a deterministic
portfolio — community-clustered BFS over the highest-degree seeds and a
neighbour-signature sort — and keeps the ordering with the lower PR_2.
A degree sort and the identity are the ablation baselines.  Every
function returns ``perm`` with node i → new ID ``perm[i]``; the trainer
permutes features, labels and masks by it, so these are the JAX
package's algorithms step for step and give the same perms.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .sparse import CSRMatrix


def rabbit_reorder(csr: CSRMatrix, community_budget: int | None = None,
                   seed: int = 0) -> np.ndarray:
    """The locality portfolio: community-clustered BFS and the
    neighbour-signature sort; returns whichever yields the lower PR_2."""
    from .pcsr import pcsr_stats

    def pr2(c):
        return pcsr_stats(c.indptr, c.indices, c.n_rows, c.n_cols,
                          2, 4).padding_ratio

    cands = [bfs_cluster_reorder(csr, community_budget, seed),
             similarity_reorder(csr)]
    best, best_pr = None, np.inf
    for perm in cands:
        p = pr2(apply_reorder(csr, perm))
        if p < best_pr:
            best, best_pr = perm, p
    return best


def similarity_reorder(csr: CSRMatrix) -> np.ndarray:
    """Sort rows by a neighbour-set signature (3 smallest neighbour ids +
    degree): rows with near-identical neighbourhoods become adjacent,
    which is what vectorized blocking needs."""
    n = csr.n_rows
    deg = csr.degrees
    sig = np.full((n, 3), csr.n_cols, np.int64)
    for j in range(3):
        has = deg > j
        sig[has, j] = csr.indices[csr.indptr[:-1][has] + j]
    order = np.lexsort((deg, sig[:, 2], sig[:, 1], sig[:, 0]))
    perm = np.empty(n, np.int64)
    perm[order] = np.arange(n)
    return perm


def bfs_cluster_reorder(csr: CSRMatrix, community_budget: int | None = None,
                        seed: int = 0) -> np.ndarray:
    """Community-clustered BFS: high-degree seeds first, each BFS stops
    *expanding* at ``community_budget`` nodes but drains its queue, so
    every visited node receives an ID.  ``seed`` is unused (the order is
    deterministic), kept for the reference's signature."""
    n = csr.n_rows
    if n == 0:
        return np.zeros(0, np.int64)
    if community_budget is None:
        community_budget = max(64, int(np.sqrt(csr.nnz + 1)))
    deg = csr.degrees
    order_seed = np.argsort(-deg, kind="stable")
    # Python lists: the walk touches every edge once from the interpreter
    visited = [False] * n
    perm = [0] * n
    nxt = 0
    indptr, indices = csr.indptr.tolist(), csr.indices.tolist()
    for s in order_seed.tolist():
        if visited[s]:
            continue
        q = deque([s])
        visited[s] = True
        count = 0
        while q:
            u = q.popleft()
            perm[u] = nxt
            nxt += 1
            count += 1
            if count < community_budget:
                for v in indices[indptr[u]:indptr[u + 1]]:
                    if not visited[v]:
                        visited[v] = True
                        q.append(v)
    if nxt != n:
        raise AssertionError(f"BFS numbered {nxt} of {n} nodes")
    return np.asarray(perm, np.int64)


def degree_reorder(csr: CSRMatrix) -> np.ndarray:
    """Descending-degree relabel (cheap locality baseline)."""
    order = np.argsort(-csr.degrees, kind="stable")
    perm = np.empty(csr.n_rows, np.int64)
    perm[order] = np.arange(csr.n_rows)
    return perm


def identity_order(csr: CSRMatrix) -> np.ndarray:
    return np.arange(csr.n_rows, dtype=np.int64)


def apply_reorder(csr: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    return csr.permute(perm)
