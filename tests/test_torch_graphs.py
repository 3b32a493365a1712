"""PyTorch port vs JAX reference: graph generators, CSR ops, sampling.

All of it is host numpy in both packages, so equality is exact and
seed-for-seed: the same seed must give the same graph, the same sampled
neighborhood and the same extracted subgraph.
"""
import numpy as np
import pytest

from repro.core.sparse import CSRMatrix as RCSR
from repro.data import graphs as rg

from repro_torch.core.sparse import CSRMatrix as TCSR
from repro_torch.data import graphs as tg

GENERATORS = {
    "rmat": lambda m, sh: m.rmat(9, 6, seed=3, shuffle=sh),
    "ba": lambda m, sh: m.ba(400, 3, seed=4, shuffle=sh),
    "er": lambda m, sh: m.er(500, 5.5, seed=5, shuffle=sh),
    "grid2d": lambda m, sh: m.grid2d(17, seed=6, shuffle=sh),
    "sbm": lambda m, sh: m.sbm(6, 40, 0.2, 1.0, seed=7, shuffle=sh),
    "clones": lambda m, sh: m.clones(150, 6, seed=8, shuffle=sh),
    "clones_undirected": lambda m, sh: m.clones(100, 5, seed=9, shuffle=sh,
                                                directed=False),
    "kregular": lambda m, sh: m.kregular(300, 6, seed=10, shuffle=sh),
}


def _same_csr(r, t):
    assert (r.n_rows, r.n_cols) == (t.n_rows, t.n_cols)
    for f in ("indptr", "indices", "data"):
        a, b = getattr(r, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_seed_for_seed(name, shuffle):
    _same_csr(GENERATORS[name](rg, shuffle), GENERATORS[name](tg, shuffle))


@pytest.mark.parametrize("scale", ["small", "skewed"])
def test_corpus_matches_reference(scale):
    r, t = rg.corpus(scale), tg.corpus(scale)
    assert [(s.name, s.family) for s in r] == [(s.name, s.family) for s in t]
    for a, b in zip(r, t):
        _same_csr(a.csr, b.csr)


def test_csr_ops_match_reference():
    g_r = rg.rmat(8, 5, seed=11)
    g_t = tg.rmat(8, 5, seed=11)
    _same_csr(g_r.gcn_normalize(), g_t.gcn_normalize())
    perm = np.random.default_rng(0).permutation(g_r.n_rows)
    _same_csr(g_r.permute(perm), g_t.permute(perm))
    A = g_r.to_dense()
    assert np.array_equal(A, g_t.to_dense())
    _same_csr(RCSR.from_dense(A), TCSR.from_dense(A))
    rows = np.array([0, 2, 2, 1, 0]); cols = np.array([1, 0, 0, 2, 1])
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    _same_csr(RCSR.from_coo(rows, cols, vals, 3, 3),
              TCSR.from_coo(rows, cols, vals, 3, 3))


@pytest.mark.parametrize("sample_seed", [0, 5, 9])
@pytest.mark.parametrize("fanouts", [(4, 2), (8, 4), (6,), (2, 2, 2)])
def test_sample_khop_and_extract_seed_for_seed(fanouts, sample_seed):
    g_r, g_t = rg.rmat(10, 6, seed=2), tg.rmat(10, 6, seed=2)
    seeds = [3, 77, 500, 1000]
    nodes_r = rg.sample_khop(g_r, seeds, fanouts, seed=sample_seed)
    nodes_t = tg.sample_khop(g_t, seeds, fanouts, seed=sample_seed)
    assert np.array_equal(nodes_r, nodes_t)
    _same_csr(rg.extract_subgraph(g_r, nodes_r),
              tg.extract_subgraph(g_t, nodes_t))


def test_sampling_edge_cases_match_reference():
    base = tg.er(200, 4, seed=3)
    g = TCSR(np.concatenate([base.indptr, [base.indptr[-1]]]), base.indices,
             base.data, base.n_rows + 1, base.n_cols + 1)
    iso = g.n_rows - 1
    assert np.array_equal(tg.sample_khop(g, [iso], (4, 4), seed=0), [iso])
    sub = tg.extract_subgraph(g, np.array([iso]))
    assert sub.n_rows == 1 and sub.indices.size == 0
    empty = tg.extract_subgraph(g, np.zeros(0, np.int64))
    assert empty.n_rows == 0
    with pytest.raises(ValueError, match="out of range"):
        tg.sample_khop(g, [g.n_rows], (2,))
