"""Synthetic graph corpus with controlled input diversity.

The paper evaluates on 202 SNAP/DIMACS10 matrices spanning data locality,
degree distribution, and size (§6.2: n 1e3–7.7e6, ρ 2.7e-7–0.025,
CV 0.006–58).  Offline we reproduce that *diversity* with deterministic
generators that target each axis:

  rmat        — power-law, high CV (social-network analogue, sx-*)
  ba          — Barabási-Albert preferential attachment (power-law)
  er          — Erdős–Rényi (Poisson degrees, balanced: road/traffic-like)
  grid2d      — lattice (extreme locality, low constant degree: DIMACS road)
  sbm         — stochastic block model (community structure: coPapers-*)
  kregular    — random regular (perfectly balanced degrees)

Each generator takes ``shuffle=True`` to destroy ID locality (the
reordering/blocking ablations toggle it).  All graphs are undirected
(symmetrized), weighted 1.0, canonical CSR.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.sparse import CSRMatrix


def _finish(src, dst, n, shuffle, seed) -> CSRMatrix:
    mask = src != dst                      # drop self loops
    src, dst = src[mask], dst[mask]
    if shuffle:
        perm = np.random.default_rng(seed + 7).permutation(n)
        src, dst = perm[src], perm[dst]
    csr = CSRMatrix.from_edges(src, dst, n, symmetrize=True)
    # binarize (duplicate edges summed by from_coo → clamp back to 1.0)
    csr.data = np.ones_like(csr.data)
    return csr


def rmat(n_log2: int, avg_deg: int, seed: int = 0, shuffle: bool = False,
         a=0.57, b=0.19, c=0.19) -> CSRMatrix:
    n = 1 << n_log2
    ne = n * avg_deg // 2
    rng = np.random.default_rng(seed)
    src = np.zeros(ne, np.int64)
    dst = np.zeros(ne, np.int64)
    for lvl in range(n_log2):
        r = rng.random(ne)
        go_s = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        go_d = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src = src * 2 + go_s
        dst = dst * 2 + go_d
    return _finish(src, dst, n, shuffle, seed)


def ba(n: int, m: int, seed: int = 0, shuffle: bool = False) -> CSRMatrix:
    """Barabási–Albert via the repeated-edge-endpoint trick (vectorized)."""
    rng = np.random.default_rng(seed)
    src_l, dst_l = [], []
    targets = np.arange(m, dtype=np.int64)
    repeated = list(range(m))
    for v in range(m, n):
        src_l.append(np.full(m, v, np.int64))
        dst_l.append(targets.copy())
        repeated.extend(targets.tolist())
        repeated.extend([v] * m)
        pick = rng.integers(0, len(repeated), m)
        targets = np.array([repeated[p] for p in pick], np.int64)
    return _finish(np.concatenate(src_l), np.concatenate(dst_l), n,
                   shuffle, seed)


def er(n: int, avg_deg: float, seed: int = 0, shuffle: bool = False) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    ne = int(n * avg_deg / 2)
    src = rng.integers(0, n, ne)
    dst = rng.integers(0, n, ne)
    return _finish(src, dst, n, shuffle, seed)


def grid2d(side: int, seed: int = 0, shuffle: bool = False) -> CSRMatrix:
    n = side * side
    idx = np.arange(n).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()])
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()])
    e = np.concatenate([right, down], axis=1)
    return _finish(e[0], e[1], n, shuffle, seed)


def sbm(n_blocks: int, block_size: int, p_in: float, p_out_deg: float,
        seed: int = 0, shuffle: bool = False) -> CSRMatrix:
    """Stochastic block model: dense communities + sparse global edges."""
    rng = np.random.default_rng(seed)
    n = n_blocks * block_size
    src_l, dst_l = [], []
    ne_in = int(p_in * block_size * (block_size - 1) / 2)
    for b in range(n_blocks):
        s = rng.integers(0, block_size, ne_in) + b * block_size
        d = rng.integers(0, block_size, ne_in) + b * block_size
        src_l.append(s)
        dst_l.append(d)
    ne_out = int(n * p_out_deg / 2)
    src_l.append(rng.integers(0, n, ne_out))
    dst_l.append(rng.integers(0, n, ne_out))
    return _finish(np.concatenate(src_l), np.concatenate(dst_l), n,
                   shuffle, seed)


def clones(n_base: int, deg: int, clone: int = 2, mutate: float = 0.15,
           seed: int = 0, shuffle: bool = False,
           directed: bool = True) -> CSRMatrix:
    """Co-citation-style graph (coPapers analogue): consecutive ``clone``
    rows share most of their neighbor set — the structure that vectorized
    blocking (V=2) exploits (low PR_2).  Directed by default: symmetrizing
    scatters the clone structure across reverse rows."""
    rng = np.random.default_rng(seed)
    n = n_base * clone
    src_l, dst_l = [], []
    for c in range(clone):
        base_dst = rng.integers(0, n, (n_base, deg))
        if c == 0:
            shared = base_dst
        else:
            mut = rng.random((n_base, deg)) < mutate
            base_dst = np.where(mut, base_dst, shared)
        rows = (np.arange(n_base) * clone + c)[:, None]
        src_l.append(np.broadcast_to(rows, base_dst.shape).ravel())
        dst_l.append(base_dst.ravel())
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    if directed:
        mask = src != dst
        src, dst = src[mask], dst[mask]
        if shuffle:
            perm = np.random.default_rng(seed + 7).permutation(n)
            src, dst = perm[src], perm[dst]
        csr = CSRMatrix.from_coo(src, dst, np.ones(src.shape[0], np.float32),
                                 n, n)
        csr.data = np.ones_like(csr.data)
        return csr
    return _finish(src, dst, n, shuffle, seed)


def kregular(n: int, k: int, seed: int = 0, shuffle: bool = False) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    src_l, dst_l = [], []
    for _ in range(k // 2):
        perm = rng.permutation(n)
        src_l.append(perm)
        dst_l.append(np.roll(perm, 1))
    return _finish(np.concatenate(src_l), np.concatenate(dst_l), n,
                   shuffle, seed)


# --------------------------------------------------------------- serving
def sample_khop(csr: CSRMatrix, seeds, fanouts, *, seed: int = 0) -> np.ndarray:
    """Seeded k-hop neighborhood with per-hop fanout caps (GraphSAGE-style).

    Hop ``i`` expands the current frontier by at most ``fanouts[i]``
    neighbors per frontier node, sampled *without replacement* via a
    vectorized sort-by-(node, random) + positional mask — no Python loop
    over nodes.  Deterministic in ``seed``: the serving tier's replay
    soak relies on same-seed → same node set.  Returns the sorted unique
    node ids of the sampled neighborhood (seeds always included, even
    seeds with empty neighborhoods).
    """
    rng = np.random.default_rng(seed)
    visited = np.unique(np.asarray(seeds, np.int64))
    if visited.size and (visited[0] < 0 or visited[-1] >= csr.n_rows):
        raise ValueError("seed node id out of range")
    frontier = visited
    for fan in fanouts:
        if frontier.size == 0 or fan <= 0:
            break
        starts = csr.indptr[frontier]
        counts = csr.indptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        seg_off = np.cumsum(counts) - counts
        flat = np.arange(total, dtype=np.int64)
        pos = flat - np.repeat(seg_off, counts) + np.repeat(starts, counts)
        nbrs = csr.indices[pos]
        seg = np.repeat(np.arange(frontier.size, dtype=np.int64), counts)
        order = np.lexsort((rng.random(total), seg))   # shuffle within node
        rank = flat - np.repeat(seg_off, counts)       # 0.. within node
        picked = nbrs[order][rank < fan]               # first ``fan`` each
        new = np.setdiff1d(np.unique(picked), visited, assume_unique=True)
        visited = np.union1d(visited, new)
        frontier = new
    return visited


def extract_subgraph(csr: CSRMatrix, nodes) -> CSRMatrix:
    """Induced subgraph on ``nodes`` with local id relabeling.

    ``nodes`` must be sorted unique global ids (what ``sample_khop``
    returns); local id ``i`` is the position of ``nodes[i]``.  Edges with
    either endpoint outside ``nodes`` are dropped.  Vectorized CSR
    range-gather — no per-node Python loop.
    """
    nodes = np.asarray(nodes, np.int64)
    m = int(nodes.size)
    if m == 0:
        return CSRMatrix(np.zeros(1, np.int64), np.zeros(0, np.int64),
                         np.zeros(0, np.float32), 0, 0)
    lookup = np.full(csr.n_cols, -1, np.int64)
    lookup[nodes] = np.arange(m, dtype=np.int64)
    starts = csr.indptr[nodes]
    counts = csr.indptr[nodes + 1] - starts
    total = int(counts.sum())
    seg_off = np.cumsum(counts) - counts
    flat = np.arange(total, dtype=np.int64)
    pos = flat - np.repeat(seg_off, counts) + np.repeat(starts, counts)
    cols_l = lookup[csr.indices[pos]]
    rows_l = np.repeat(np.arange(m, dtype=np.int64), counts)
    keep = cols_l >= 0
    return CSRMatrix.from_coo(rows_l[keep], cols_l[keep],
                              csr.data[pos][keep], m, m,
                              sum_duplicates=False)


@dataclass
class GraphSpec:
    name: str
    csr: CSRMatrix
    family: str


def corpus(scale: str = "small") -> list[GraphSpec]:
    """Deterministic graph corpus. ``small`` ≈ unit tests / CI;
    ``bench`` ≈ decider training + paper-table benchmarks; ``skewed`` ≈
    degree-skew stressors (high-CV power-law / co-citation graphs, where
    the balanced ``B`` chunk schedule should win) plus uniform-degree
    controls (where it should NOT be selected) — the corpus behind
    ``benchmarks/bench_spmm.py`` and the balanced-scheduling tests;
    ``large`` ≈ the calibration / adaptivity-at-scale tier (bigger
    rmat/ba/sbm plus ``clones`` skew): graphs big enough that config
    choice moves wall-clock by integer factors, so priced-vs-measured
    rank correlation on it is a meaningful claim — opt-in only (never
    generated in tier-1 CI)."""
    out = []

    def add(name, family, g):
        out.append(GraphSpec(name, g, family))

    if scale == "large":
        add("rmat16", "powerlaw", rmat(16, 8, seed=21))
        add("rmat17", "powerlaw", rmat(17, 6, seed=22))
        add("rmat16_sh", "powerlaw", rmat(16, 8, seed=21, shuffle=True))
        add("ba100k", "powerlaw", ba(100_000, 4, seed=23))
        add("sbm64x1k", "community", sbm(64, 1024, 0.02, 1.0, seed=24))
        add("sbm128x512", "community", sbm(128, 512, 0.04, 1.0, seed=25))
        add("clones50k", "cocitation", clones(50_000, 10, seed=26))
        add("clones25k_sh", "cocitation",
            clones(25_000, 12, seed=27, shuffle=True))
        add("er250k", "uniform", er(250_000, 6, seed=28))
        add("kreg150k", "uniform", kregular(150_000, 6, seed=29))
        add("grid512", "mesh", grid2d(512, seed=30))
        return out

    if scale == "skewed":
        add("rmat11", "powerlaw", rmat(11, 8, seed=11))
        add("rmat12", "powerlaw", rmat(12, 6, seed=12))
        add("ba2k", "powerlaw", ba(2000, 4, seed=13))
        add("ba4k", "powerlaw", ba(4000, 3, seed=14))
        add("clones1k", "cocitation", clones(1000, 10, seed=15))
        add("kreg2k", "uniform", kregular(2000, 8, seed=16))
        add("grid48", "mesh", grid2d(48, seed=17))
        return out

    if scale == "serve":
        # Serving-tier base graphs: big enough that sampled subgraphs
        # span several shape buckets, small enough for CI smoke streams.
        add("rmat13", "powerlaw", rmat(13, 8, seed=31))
        add("ba10k", "powerlaw", ba(10_000, 4, seed=32))
        add("sbm32x256", "community", sbm(32, 256, 0.12, 1.0, seed=33))
        add("er20k", "uniform", er(20_000, 6, seed=34))
        add("grid128", "mesh", grid2d(128, seed=35))
        return out

    if scale == "small":
        add("rmat10", "powerlaw", rmat(10, 8, seed=1))
        add("er1k", "uniform", er(1000, 8, seed=2))
        add("grid32", "mesh", grid2d(32, seed=3))
        add("sbm8x64", "community", sbm(8, 64, 0.3, 1.0, seed=4))
        add("ba1k", "powerlaw", ba(1000, 4, seed=5))
        return out

    sizes = [(12, 8), (13, 8), (14, 6), (15, 4), (16, 4)]
    seed = 0
    for lg, d in sizes:
        for sh in (False, True):
            tag = "_sh" if sh else ""
            add(f"rmat{lg}{tag}", "powerlaw", rmat(lg, d, seed, shuffle=sh))
            seed += 1
    for n, d in [(4000, 6), (16000, 8), (60000, 6), (150000, 4)]:
        for sh in (False, True):
            tag = "_sh" if sh else ""
            add(f"er{n}{tag}", "uniform", er(n, d, seed, shuffle=sh))
            seed += 1
    for side in (64, 128, 256, 384):
        for sh in (False, True):
            tag = "_sh" if sh else ""
            add(f"grid{side}{tag}", "mesh", grid2d(side, seed, shuffle=sh))
            seed += 1
    for nb, bs, pin in [(16, 128, 0.25), (32, 256, 0.12), (64, 512, 0.03),
                        (24, 1024, 0.015)]:
        for sh in (False, True):
            tag = "_sh" if sh else ""
            add(f"sbm{nb}x{bs}{tag}", "community",
                sbm(nb, bs, pin, 1.0, seed, shuffle=sh))
            seed += 1
    for n, k in [(8000, 8), (40000, 6), (120000, 4)]:
        add(f"kreg{n}", "uniform", kregular(n, k, seed))
        seed += 1
    for n, m in [(4000, 6), (20000, 5), (80000, 3)]:
        add(f"ba{n}", "powerlaw", ba(n, m, seed))
        seed += 1
    for nb, d in [(4000, 12), (16000, 10), (50000, 8)]:
        for sh in (False, True):
            tag = "_sh" if sh else ""
            add(f"clones{nb}{tag}", "cocitation",
                clones(nb, d, seed=seed, shuffle=sh))
            seed += 1
    return out
