"""PyTorch port vs JAX reference: host-side PCSR packing and pricing.

The port's ``repro_torch.core`` must pack array-for-array what
``repro.core.pcsr`` packs (so one pack could feed either kernel), and its
cost model — given the reference's TPU constants — must price and pick
exactly as ``repro.core.cost_model`` does.
"""
import numpy as np
import pytest

import repro.core.cost_model as rcm
from repro.core import pcsr as rp
from repro.core.sparse import CSRMatrix as RCSR

from repro_torch.core import cost_model as tcm
from repro_torch.core import pcsr as tp
from repro_torch.core.sparse import CSRMatrix as TCSR

from conftest import random_csr

REF_HW = tcm.Hardware(hbm_bw=rcm.HBM_BW, flops=rcm.VPU_FLOPS,
                      step_overhead=rcm.STEP_OVERHEAD,
                      chunk_setup=rcm.CHUNK_SETUP,
                      dtype_bytes=rcm.DTYPE_BYTES)

CONFIGS = rp.config_space(64)
PCSR_FIELDS = ("colidx", "lrow", "trow", "init", "fini", "vals")


def _graph(kind: str):
    """(reference CSR, port CSR) of one test graph, from a seed."""
    rng = np.random.default_rng({"skewed": 0, "empty": 1, "uniform": 2}[kind])
    if kind == "skewed":
        csr, _ = random_csr(rng, 90, density=0.04, skew=True)
    elif kind == "empty":
        # whole row blocks without a nonzero, under every R ∈ {8, 16, 32}
        _, A = random_csr(rng, 100, density=0.08)
        A[8:72] = 0.0
        csr = RCSR.from_dense(A)
    else:
        csr, _ = random_csr(rng, 64, density=0.1)
    return csr, TCSR(csr.indptr.copy(), csr.indices.copy(), csr.data.copy(),
                     csr.n_rows, csr.n_cols)


def _port_config(cfg):
    return tp.SpMMConfig(V=cfg.V, S=cfg.S, F=cfg.F, W=cfg.W, B=cfg.B)


def _build(mod, csr, cfg, **kw):
    return mod.build_pcsr(csr.indptr, csr.indices, csr.data, csr.n_rows,
                          csr.n_cols, cfg, **kw)


def _assert_same_pcsr(r, t):
    for f in PCSR_FIELDS:
        a, b = getattr(r, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("n_rows", "n_cols", "n_blocks", "K", "nnz", "nnz_vec",
              "n_nonempty_blocks", "num_chunks", "n_empty_blocks",
              "covered_num_chunks"):
        assert getattr(r, f) == getattr(t, f), f
    rs, ts = r.steering(covered=True), t.steering(covered=True)
    for f in PCSR_FIELDS:
        assert np.array_equal(rs[f], ts[f]), f"covered {f}"


@pytest.mark.parametrize("kind", ["skewed", "empty", "uniform"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: str(c.astuple()))
def test_build_pad_and_steering_match_reference(kind, cfg):
    rcsr, tcsr = _graph(kind)
    r, t = _build(rp, rcsr, cfg), _build(tp, tcsr, _port_config(cfg))
    assert t.config.astuple() == cfg.astuple()
    _assert_same_pcsr(r, t)
    n_pad = -(-rcsr.n_rows // cfg.R) * cfg.R + cfg.R
    budget = r.covered_num_chunks + cfg.R // 8 + 3
    _assert_same_pcsr(rp.pad_pcsr(r, n_rows=n_pad, num_chunks=budget),
                      tp.pad_pcsr(t, n_rows=n_pad, num_chunks=budget))


@pytest.mark.parametrize("capacity", [3, 40])
def test_capacity_override_matches_reference(capacity):
    rcsr, tcsr = _graph("skewed")
    for cfg in (rp.SpMMConfig(V=1, S=True, W=8),
                rp.SpMMConfig(V=2, S=True, W=4, B=True)):
        _assert_same_pcsr(_build(rp, rcsr, cfg, capacity=capacity),
                          _build(tp, tcsr, _port_config(cfg),
                                 capacity=capacity))


def test_empty_matrix_matches_reference():
    z = (np.zeros(33, np.int64), np.zeros(0, np.int64),
         np.zeros(0, np.float32), 32, 32)
    for cfg in CONFIGS[:6]:
        r = rp.build_pcsr(*z, cfg)
        t = tp.build_pcsr(*z, _port_config(cfg))
        _assert_same_pcsr(r, t)


def test_pad_pcsr_errors_match_reference():
    rcsr, tcsr = _graph("uniform")
    cfg = rp.SpMMConfig(V=1, S=True, W=8)
    r, t = _build(rp, rcsr, cfg), _build(tp, tcsr, _port_config(cfg))
    for kw, msg in (({"n_rows": 128, "num_chunks": 1}, "chunk budget"),
                    ({"n_rows": 16, "num_chunks": 1000}, "smaller than"),
                    ({"n_rows": 64, "num_chunks": r.num_chunks + 1},
                     "empty block")):
        with pytest.raises(ValueError, match=msg):
            rp.pad_pcsr(r, **kw)
        with pytest.raises(ValueError, match=msg):
            tp.pad_pcsr(t, **kw)


@pytest.mark.parametrize("kind", ["skewed", "empty", "uniform"])
def test_pcsr_stats_match_reference(kind):
    rcsr, tcsr = _graph(kind)
    for V, W in ((1, 8), (1, 16), (1, 32), (2, 4), (2, 8), (2, 16)):
        r = rp.pcsr_stats(rcsr.indptr, rcsr.indices, rcsr.n_rows,
                          rcsr.n_cols, V, W)
        t = tp.pcsr_stats(tcsr.indptr, tcsr.indices, tcsr.n_rows,
                          tcsr.n_cols, V, W)
        for f in ("n_rows", "n_cols", "nnz", "V", "W", "nnz_vec", "n_blocks",
                  "n_nonempty_blocks", "max_block", "mean_block",
                  "padding_ratio"):
            assert getattr(r, f) == getattr(t, f), f
        assert np.array_equal(r.counts_hist, t.counts_hist)
        for S, B in ((False, False), (True, False), (True, True)):
            assert r.chunks_and_slots(S, B=B) == t.chunks_and_slots(S, B=B)


@pytest.mark.parametrize("kind", ["skewed", "empty", "uniform"])
@pytest.mark.parametrize("dim", [16, 64, 200])
def test_cost_model_best_matches_reference(kind, dim):
    rcsr, tcsr = _graph(kind)
    r_cfg, r_t = rcm.CostModel(rcsr).best(dim, rp.config_space(dim))
    t_cfg, t_t = tcm.CostModel(tcsr, REF_HW).best(dim, tp.config_space(dim))
    assert t_cfg.astuple() == r_cfg.astuple()
    assert t_t == r_t


@pytest.mark.parametrize("kind", ["skewed", "empty"])
def test_kernel_cost_breakdown_matches_reference(kind):
    rcsr, tcsr = _graph(kind)
    rmodel, tmodel = rcm.CostModel(rcsr), tcm.CostModel(tcsr, REF_HW)
    for cfg in rp.config_space(200):
        for kw in ({}, {"epilogue": True}, {"residual": True},
                   {"H": 4}):
            r = rmodel.cost(200, cfg, **kw)
            t = tmodel.cost(200, _port_config(cfg), **kw)
            assert vars(r) == vars(t), (cfg, kw)
        assert (rmodel.time(200, cfg, epilogue=True)
                == tmodel.time(200, _port_config(cfg), epilogue=True))


def test_cost_model_h100_default_and_unported_ops():
    _, tcsr = _graph("skewed")
    model = tcm.CostModel(tcsr)
    assert model.hardware is tcm.H100
    cfg, t = model.best(64, tp.config_space(64))
    assert cfg in tp.config_space(64) and 0 < t < np.inf
    # "gat" is a pair of kernels: it has a time but no single breakdown,
    # as in the reference
    assert model.time(64, cfg, op="gat") > model.time(64, cfg)
    with pytest.raises(ValueError, match="single-kernel"):
        model.cost(64, cfg, op="gat")
    with pytest.raises(ValueError):
        model.cost(64, cfg, op="attention")


def test_config_space_matches_reference():
    for dim in (1, 16, 64, 128, 129, 200, 600):
        assert ([c.astuple() for c in tp.config_space(dim)]
                == [c.astuple() for c in rp.config_space(dim)])
    with pytest.raises(ValueError):
        tp.SpMMConfig(S=False, B=True)
