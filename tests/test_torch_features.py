"""PyTorch port vs JAX reference: the SpMM-decider's matrix features
(paper Table 3).

``repro_torch.core.features.extract_features`` is float64 numpy in both
packages over packings that match array for array, so its values — and
the decider's encoded vectors — must be *equal* to the reference's, not
merely close.
"""
import functools

import numpy as np
import pytest

from repro.core import features as rf
from repro.core.sparse import CSRMatrix as RCSR
from repro.data.graphs import corpus as ref_corpus

from repro_torch.core import features as tf
from repro_torch.core.sparse import CSRMatrix as TCSR
from repro_torch.data.graphs import corpus

DIMS = (16, 64, 128, 200)
SCALES = {"small": ("rmat10", "er1k", "grid32", "sbm8x64", "ba1k"),
          "skewed": ("rmat11", "rmat12", "ba2k", "ba4k", "clones1k",
                     "kreg2k", "grid48")}


@functools.lru_cache(maxsize=None)
def _corpora(scale):
    return ({g.name: g.csr for g in ref_corpus(scale)},
            {g.name: g.csr for g in corpus(scale)})


def _pair(csr):
    """(reference CSR, port CSR) over copies of the same arrays."""
    return (RCSR(csr.indptr.copy(), csr.indices.copy(), csr.data.copy(),
                 csr.n_rows, csr.n_cols),
            TCSR(csr.indptr.copy(), csr.indices.copy(), csr.data.copy(),
                 csr.n_rows, csr.n_cols))


def _assert_same(rcsr, tcsr):
    r, t = rf.extract_features(rcsr), tf.extract_features(tcsr)
    assert r.values.dtype == t.values.dtype == np.float64
    np.testing.assert_array_equal(t.values, r.values)
    assert t.as_dict() == r.as_dict()
    for dim in DIMS + (None,):
        np.testing.assert_array_equal(t.vector(dim), r.vector(dim))


def test_feature_names_match_reference():
    assert tf.FEATURE_NAMES == rf.FEATURE_NAMES


def test_corpus_names_are_the_tiers():
    for scale, names in SCALES.items():
        ref, port = _corpora(scale)
        assert tuple(ref) == tuple(port) == names


@pytest.mark.parametrize("scale,name", [
    (s, n) for s, names in SCALES.items() for n in names])
def test_corpus_features_equal_reference(scale, name):
    ref, port = _corpora(scale)
    np.testing.assert_array_equal(port[name].indptr, ref[name].indptr)
    np.testing.assert_array_equal(port[name].indices, ref[name].indices)
    _assert_same(*_pair(port[name]))


@pytest.mark.parametrize("shape", [(0, 0), (7, 7), (1, 9), (1, 1)])
def test_empty_and_one_row_features(shape):
    n, m = shape
    A = np.zeros((n, m), np.float32)
    if shape == (1, 9):
        A[0, [0, 4, 8]] = 1.0                  # one row, bandwidth 8
    elif shape == (1, 1):
        A[0, 0] = 2.0
    _assert_same(*_pair(RCSR.from_dense(A)))


def test_crafted_matrix_values():
    # the reference test's matrix: degrees 2, 2, 0, 4; bandwidths 3, 1, 3
    A = np.array([[1, 0, 0, 1], [0, 1, 1, 0], [0, 0, 0, 0], [1, 1, 1, 1]],
                 np.float32)
    f = tf.extract_features(TCSR.from_dense(A)).as_dict()
    assert (f["n"], f["n_hat"], f["nnz"], f["d"], f["d_max"]) == \
        (4, 3, 8, 2.0, 4.0)
    assert f["bw_max"] == 3.0 and f["pr_1"] == 0.0
    deg = np.array([2, 2, 0, 4.0])
    assert f["cv"] == pytest.approx(deg.std() / deg.mean(), abs=1e-12)
