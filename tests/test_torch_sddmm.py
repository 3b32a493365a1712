"""PyTorch port vs JAX reference: the fused SDDMM → softmax-stats operator
and the ParamSpMM softmax prologue.

``sddmm_softmax_stats`` (on CPU tensors: the CUDA kernel's plain version)
is held against the reference's Pallas kernel in interpret mode for every
V/S/B combination at R ∈ {8, 16, 32}: with integer-valued Q/K at d ∈
{16, 64} the logits are bit-equal (−inf at the same slots) and the row
stats agree within ``rtol=1e-5, atol=1e-6`` on rows with an edge (the
port sums in two passes, the reference online); with float operands
everything agrees within ``rtol=1e-5, atol=1e-5``.  The port's logits are
in the covered layout, whose first ``num_chunks`` chunks are the
reference's; its stats are dense ``(H, n_blocks·R)`` and the reference's
are converted with ``unpack_stats``.  ``paramspmm_with_vals(stats=)`` is
held against the reference's at ``rtol=1e-5, atol=1e-5``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as rengine
from repro.core import pcsr as rp
from repro.core.sparse import CSRMatrix as RCSR
from repro.kernels.paramspmm import ops as rpops
from repro.kernels.sddmm import ops as rsops
from repro.kernels.sddmm.ref import sddmm_slots_ref as r_slots_ref

from repro_torch.core import engine as tengine
from repro_torch.core import pcsr as tp
from repro_torch.kernels.paramspmm import ops as pops
from repro_torch.kernels.sddmm import ops
from repro_torch.kernels.sddmm.ref import sddmm_slots_ref

from conftest import random_csr

CONFIGS = [tp.SpMMConfig(V=v, S=s, B=b, W=r // v)
           for v in (1, 2) for (s, b) in ((False, False), (True, False),
                                          (True, True))
           for r in (8, 16, 32)]
RTOL, ATOL_STATS, ATOL = 1e-5, 1e-6, 1e-5


def _rcfg(cfg):
    return rp.SpMMConfig(V=cfg.V, S=cfg.S, F=cfg.F, W=cfg.W, B=cfg.B)


def _pair(cfg, csr):
    """(reference PCSR, port PCSR) of one CSR."""
    args = (csr.indptr, csr.indices, csr.data, csr.n_rows, csr.n_cols)
    return rp.build_pcsr(*args, _rcfg(cfg)), tp.build_pcsr(*args, cfg)


def _skewed(seed=0, n=56):
    """A skewed graph with an empty band of rows."""
    rng = np.random.default_rng(seed)
    _, A = random_csr(rng, n, density=0.08, skew=True)
    A[12:30] = 0.0
    return RCSR.from_dense(A)


def _masked(seed=0, n=64):
    """Empty-row band plus explicit zeros stored as edges (masked)."""
    rng = np.random.default_rng(seed)
    A = ((rng.random((n, n)) < 0.2)
         * rng.standard_normal((n, n))).astype(np.float32)
    A[8:40] = 0.0
    rows, cols = np.nonzero(A)
    vals = A[rows, cols].copy()
    vals[::5] = 0.0                       # every 5th stored edge masked out
    return RCSR.from_coo(rows, cols, vals, n, n, sum_duplicates=False)


def _edge_rows(csr):
    """Rows with at least one real (nonzero-valued) edge."""
    rows = np.repeat(np.arange(csr.n_rows), np.diff(csr.indptr))
    return np.unique(rows[csr.data != 0])


def _draw(rng, shape, integer):
    if integer:
        return rng.integers(-3, 4, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _ref_stats(r, Q, K):
    """Reference logits and dense stats ``(H, n_blocks·R)`` (or without H)."""
    lg, rm, rs = rsops.sddmm_softmax_stats(r, jnp.asarray(Q), jnp.asarray(K),
                                           interpret=True)
    R = r.config.R
    shape = (-1,) if Q.ndim == 2 else (Q.shape[0], -1)
    dense = lambda s: np.asarray(rsops.unpack_stats(s, R)).reshape(shape)
    return np.asarray(lg), dense(rm), dense(rs)


def _port_stats(t, Q, K):
    lg, rm, rs = ops.sddmm_softmax_stats(t, torch.from_numpy(Q),
                                         torch.from_numpy(K))
    return lg.numpy(), rm.numpy(), rs.numpy()


def _assert_stats(t, got, want, rows, *, exact_logits, atol_stats):
    lg, rm, rs = got
    r_lg, r_rm, r_rs = want
    C = t.num_chunks
    assert lg.shape[-3:] == (t.covered_num_chunks, t.config.V, t.K)
    assert rm.shape[-1] == rs.shape[-1] == t.n_blocks * t.config.R
    if exact_logits:
        assert np.array_equal(lg[..., :C, :, :], r_lg)
    else:
        np.testing.assert_allclose(lg[..., :C, :, :], r_lg, rtol=RTOL,
                                   atol=ATOL)
    assert np.array_equal(np.isneginf(lg[..., :C, :, :]), np.isneginf(r_lg))
    assert np.isneginf(lg[..., C:, :, :]).all(), "coverage chunks are −inf"
    np.testing.assert_allclose(rm[..., rows], r_rm[..., rows], rtol=RTOL,
                               atol=atol_stats)
    np.testing.assert_allclose(rs[..., rows], r_rs[..., rows], rtol=RTOL,
                               atol=atol_stats)
    others = np.setdiff1d(np.arange(rm.shape[-1]), rows)
    assert np.isneginf(rm[..., others]).all() and (rs[..., others] == 0).all()


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: str(c.astuple()))
def test_stats_match_pallas_interpret(cfg):
    csr = _skewed()
    r, t = _pair(cfg, csr)
    rows = _edge_rows(csr)
    rng = np.random.default_rng(1)
    for d in (16, 64):
        for integer in (True, False):
            Q = _draw(rng, (csr.n_rows, d), integer)
            K = _draw(rng, (csr.n_cols, d), integer)
            _assert_stats(t, _port_stats(t, Q, K), _ref_stats(r, Q, K), rows,
                          exact_logits=integer,
                          atol_stats=ATOL_STATS if integer else ATOL)


@pytest.mark.parametrize("cfg", [tp.SpMMConfig(V=2, S=True, W=4),
                                 tp.SpMMConfig(V=1, S=False, W=8),
                                 tp.SpMMConfig(V=2, S=True, W=8, B=True)],
                         ids=lambda c: str(c.astuple()))
def test_empty_rows_masked_edges_and_zero_logits(cfg):
    csr = _masked()
    r, t = _pair(cfg, csr)
    rows = _edge_rows(csr)
    rng = np.random.default_rng(2)
    Q = _draw(rng, (csr.n_rows, 16), True)
    K = _draw(rng, (csr.n_cols, 16), True)
    zero = rows[len(rows) // 2]
    Q[zero] = 0.0                         # every edge of this row: logit 0
    got, want = _port_stats(t, Q, K), _ref_stats(r, Q, K)
    _assert_stats(t, got, want, rows, exact_logits=True,
                  atol_stats=ATOL_STATS)
    lg = got[0]
    stored = t.steering(covered=True)["vals"]
    # masked slots (stored zeros, padding) are −inf, nothing else is
    assert np.array_equal(np.isneginf(lg), stored == 0)
    # the zero-logit row: max 0, Σexp = its edge count, α uniform
    deg = int(np.count_nonzero(csr.data[csr.indptr[zero]:
                                        csr.indptr[zero + 1]]))
    assert got[1][zero] == 0.0 and got[2][zero] == deg
    alpha = ops.sddmm_softmax(t, torch.from_numpy(Q),
                              torch.from_numpy(K)).numpy()
    slot_rows = tengine._slot_rows(torch.from_numpy(t.lrow),
                                   torch.from_numpy(t.trow), V=t.config.V,
                                   R=t.config.R, K=t.K).numpy()
    in_row = (slot_rows == zero) & (t.vals != 0)
    np.testing.assert_allclose(alpha[:t.num_chunks][in_row], 1.0 / deg,
                               rtol=RTOL)
    assert (alpha[stored == 0] == 0).all()


def test_multihead_matches_reference_head_batch():
    cfg = tp.SpMMConfig(V=2, S=True, W=8)
    csr = _skewed(seed=3)
    r, t = _pair(cfg, csr)
    rng = np.random.default_rng(4)
    for integer in (True, False):
        Q = _draw(rng, (4, csr.n_rows, 16), integer)
        K = _draw(rng, (4, csr.n_cols, 16), integer)
        got, want = _port_stats(t, Q, K), _ref_stats(r, Q, K)
        assert got[0].shape[0] == got[1].shape[0] == 4
        _assert_stats(t, got, want, _edge_rows(csr), exact_logits=integer,
                      atol_stats=ATOL_STATS if integer else ATOL)
        # each head is the single-head call on its own operands
        for h in (0, 3):
            one = _port_stats(t, Q[h], K[h])
            for a, b in zip(one, got):
                assert np.array_equal(a, b[h])


@pytest.mark.parametrize("cfg", [tp.SpMMConfig(V=1, S=True, W=16),
                                 tp.SpMMConfig(V=2, S=False, W=4)],
                         ids=lambda c: str(c.astuple()))
def test_alpha_matches_reference_and_engine(cfg):
    csr = _masked(seed=5, n=48)
    r, t = _pair(cfg, csr)
    rng = np.random.default_rng(6)
    Q = _draw(rng, (csr.n_rows, 16), False)
    K = _draw(rng, (csr.n_cols, 16), False)
    alpha = ops.sddmm_softmax(t, torch.from_numpy(Q),
                              torch.from_numpy(K)).numpy()
    C = t.num_chunks
    want = np.asarray(rsops.sddmm_softmax(r, Q, K, interpret=True))
    np.testing.assert_allclose(alpha[:C], want, rtol=RTOL, atol=ATOL_STATS)
    assert (alpha[C:] == 0).all()
    # the engine's plain attention step: SDDMM → /√d → LeakyReLU → softmax
    st = {k: torch.from_numpy(v) for k, v in t.steering().items()}
    scores = tengine.engine_sddmm(t, torch.from_numpy(Q),
                                  torch.from_numpy(K))
    rows = tengine._slot_rows(st["lrow"], st["trow"], V=cfg.V, R=cfg.R,
                              K=t.K)
    eng = tengine.attend_scores(scores, st["vals"] != 0, rows,
                                t.n_blocks * cfg.R, dim_k=16).numpy()
    np.testing.assert_allclose(alpha[:C], eng, rtol=RTOL, atol=ATOL_STATS)


@pytest.mark.parametrize("cfg", [tp.SpMMConfig(V=1, S=True, F=1, W=16),
                                 tp.SpMMConfig(V=2, S=True, F=2, W=4,
                                               B=True),
                                 tp.SpMMConfig(V=2, S=False, F=1, W=8)],
                         ids=lambda c: str(c.astuple()))
def test_prologue_spmm_matches_reference(cfg):
    csr = _masked(seed=7, n=48)
    r, t = _pair(cfg, csr)
    rng = np.random.default_rng(8)
    Q = _draw(rng, (csr.n_rows, 16), True)
    K = _draw(rng, (csr.n_cols, 16), True)
    Q[_edge_rows(csr)[0]] = 0.0           # a row whose logits are all 0
    B = _draw(rng, (csr.n_cols, 24), False)
    r_lg, r_rm, r_rs = rsops.sddmm_softmax_stats(r, Q, K, interpret=True)
    want = np.asarray(rpops.paramspmm_with_vals(
        r, r_lg, jnp.asarray(B), stats=(r_rm, r_rs), interpret=True))
    lg, rm, rs = ops.sddmm_softmax_stats(t, torch.from_numpy(Q),
                                         torch.from_numpy(K))
    Bt = torch.from_numpy(B)
    launches = pops.launch_count()
    got = pops.paramspmm_with_vals(t, lg, Bt, stats=(rm, rs)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert pops.launch_count() == launches, "CPU tensors launch nothing"
    # the prologue is normalize_from_stats followed by the plain SpMM
    st = pops.device_steering(t, "cpu")
    alpha = ops.normalize_from_stats(lg, rm, rs, st.lrow, st.trow,
                                     R=cfg.R, V=cfg.V, K=t.K)
    via = pops.paramspmm_with_vals(t, alpha, Bt).numpy()
    np.testing.assert_allclose(got, via, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="explicit logits"):
        pops.paramspmm_with_vals(t, None, Bt, stats=(rm, rs))
    with pytest.raises(ValueError, match="rowmax"):
        pops.paramspmm_with_vals(t, lg, Bt, stats=(rm[:-1], rs))
    if t.covered_num_chunks > t.num_chunks:
        with pytest.raises(ValueError, match="covered layout"):
            pops.paramspmm_with_vals(t, lg[:t.num_chunks], Bt,
                                     stats=(rm, rs))


def test_prologue_spmm_multihead_matches_reference():
    cfg = tp.SpMMConfig(V=2, S=True, W=8)
    csr = _skewed(seed=9)
    r, t = _pair(cfg, csr)
    rng = np.random.default_rng(10)
    Q = _draw(rng, (4, csr.n_rows, 8), False)
    K = _draw(rng, (4, csr.n_cols, 8), False)
    B = _draw(rng, (4, csr.n_cols, 8), False)
    r_lg, r_rm, r_rs = rsops.sddmm_softmax_stats(r, Q, K, interpret=True)
    want = np.asarray(rpops.paramspmm_with_vals(
        r, r_lg, jnp.asarray(B), stats=(r_rm, r_rs), interpret=True))
    lg, rm, rs = ops.sddmm_softmax_stats(t, torch.from_numpy(Q),
                                         torch.from_numpy(K))
    got = pops.paramspmm_with_vals(t, lg, torch.from_numpy(B),
                                   stats=(rm, rs)).numpy()
    assert got.shape == (4, csr.n_rows, 8)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError, match="single-head"):
        pops.paramspmm_with_vals(t, lg, torch.from_numpy(B), stats=(rm, rs),
                                 activation="relu")


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_sddmm_and_softmax_match_reference(seed):
    rng = np.random.default_rng(seed)
    csr = _masked(seed=seed, n=40)
    for cfg in (tp.SpMMConfig(V=1, S=False, W=8),
                tp.SpMMConfig(V=2, S=True, W=8, B=True)):
        r, t = _pair(cfg, csr)
        Q = _draw(rng, (csr.n_rows, 12), False)
        K = _draw(rng, (csr.n_cols, 12), False)
        want = np.asarray(rengine.engine_sddmm(r, Q, K))
        got = tengine.engine_sddmm(t, torch.from_numpy(Q),
                                   torch.from_numpy(K)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            got, sddmm_slots_ref(t, torch.from_numpy(Q),
                                 torch.from_numpy(K)).numpy(),
            rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r_slots_ref(r, Q, K), want, rtol=RTOL,
                                   atol=ATOL)
        rst = r.steering()
        r_rows = np.asarray(rengine._slot_rows(
            jnp.asarray(rst["lrow"]), jnp.asarray(rst["trow"]), V=cfg.V,
            R=cfg.R, K=r.K))
        st = {k: torch.from_numpy(v) for k, v in t.steering().items()}
        rows = tengine._slot_rows(st["lrow"], st["trow"], V=cfg.V, R=cfg.R,
                                  K=t.K)
        assert np.array_equal(rows.numpy(), r_rows)
        mask = st["vals"] != 0
        a_want = np.asarray(rengine.attend_scores(
            jnp.asarray(want), jnp.asarray(mask.numpy()), jnp.asarray(r_rows),
            r.n_blocks * cfg.R, dim_k=12))
        a_got = tengine.attend_scores(torch.from_numpy(got), mask, rows,
                                      t.n_blocks * cfg.R, dim_k=12).numpy()
        np.testing.assert_allclose(a_got, a_want, rtol=RTOL,
                                   atol=ATOL_STATS)


def test_wrapper_dispatch_and_bad_operands():
    cfg = tp.SpMMConfig(V=1, S=True, W=8)
    csr = _skewed(seed=11, n=40)
    _, t = _pair(cfg, csr)
    Q = torch.ones((csr.n_rows, 8))
    launches = ops.launch_count()
    ops.sddmm_softmax_stats(t, Q, Q)
    assert ops.launch_count() == launches, "CPU tensors launch nothing"
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.sddmm_softmax_stats(t, Q.to("meta"), Q.to("meta"))
    with pytest.raises(ValueError, match="Q must be"):
        ops.sddmm_softmax_stats(t, Q[:-1], Q)
    with pytest.raises(ValueError, match="Q must be"):
        ops.sddmm_softmax_stats(t, Q, Q[:, :4])
