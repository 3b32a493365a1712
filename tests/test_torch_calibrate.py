"""PyTorch port vs JAX reference: cost-model calibration.

The fitter (``nnls``, ``fit_columns``, ``spearman``, ``fit``) is numpy in
both packages and must agree on the reference test's synthetic design;
an artifact of either package loads in the other; and the reference's
CPU artifact, loaded in the port and priced with the reference's
constants (``REF_HW``), prices and picks exactly as the reference does,
fused and unfused.  No wall-clock gate runs here: how the port's prices
rank configs against measured kernel time is measured on the card
(``chip_smoke.py`` phase 13).
"""
import json
import pathlib

import numpy as np
import pytest

from repro.core import calibrate as rc
from repro.core import cost_model as rcm
from repro.core.calibrate import CalibrationSample as RSample
from repro.data.graphs import corpus as ref_corpus

from repro_torch.core import calibrate as tc
from repro_torch.core import cost_model as tcm
from repro_torch.core.pcsr import SpMMConfig
from repro_torch.data.graphs import corpus

from test_torch_pcsr import REF_HW

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU_ARTIFACT = ROOT / "configs" / "calibration_cpu_host.json"
H100_ARTIFACT = ROOT / "configs" / "calibration_h100.json"
RTOL = 1e-12


def _log_uniform_design(rng, n=240, noise=0.02):
    """tests/test_calibration.py's synthetic design."""
    X = np.stack([
        np.ones(n),
        10 ** rng.uniform(3, 8, n),     # bytes
        10 ** rng.uniform(4, 9, n),     # flops
        10 ** rng.uniform(1, 6, n),     # steps
        10 ** rng.uniform(0, 4, n),     # chunk setups
    ], axis=1)
    true = np.array([2e-5, 1 / 80e9, 1 / 5e10, 3e-7, 1e-6])
    y = X @ true * (1.0 + noise * rng.standard_normal(n))
    return X, y, true


def _port_cfg(c):
    w, f, v, s, b = c.astuple()
    return SpMMConfig(V=v, S=s, F=f, W=w, B=b)


def test_columns_match_reference():
    assert tc.COLUMNS == rc.COLUMNS
    assert (tc.GATE_GRAPHS, tc.GATE_DIMS, tc.GATE_REPS) == \
        (rc.GATE_GRAPHS, rc.GATE_DIMS, rc.GATE_REPS)
    assert tc.reference_coefficients(REF_HW) == rc.reference_coefficients()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fitter_equals_reference(seed):
    X, y, true = _log_uniform_design(np.random.default_rng(seed))
    c_t, c_r = tc.fit_columns(X, y), rc.fit_columns(X, y)
    np.testing.assert_allclose(c_t, c_r, rtol=RTOL, atol=0)
    assert np.abs(c_t - true).max() <= 0.10 * true.max()
    A = X[:, :4] / X[:, :4].max(axis=0)
    b = A @ np.array([1.0, -0.5, 2.0, 0.0])
    np.testing.assert_allclose(tc.nnls(A, b), rc.nnls(A, b), rtol=RTOL,
                               atol=0)
    assert (tc.nnls(A, b) >= 0).all()
    np.testing.assert_allclose(tc.spearman(X[:, 1], y),
                               rc.spearman(X[:, 1], y), rtol=RTOL, atol=0)


@pytest.mark.parametrize("x,y", [([1, 2, 3, 4], [10, 20, 30, 40]),
                                 ([1, 2, 3, 4], [4, 3, 2, 1]),
                                 ([1, 1, 2], [1, 2, 3]),
                                 ([5, 5, 5], [1, 2, 3])])
def test_spearman_known_values(x, y):
    assert tc.spearman(x, y) == rc.spearman(x, y)


def _synthetic_samples(seed):
    X, y, _ = _log_uniform_design(np.random.default_rng(seed), n=60)
    ops = ("spmm", "sddmm")
    t = [tc.CalibrationSample("g", ops[i % 2], 64, (8, 1, 1, True, False),
                              X[i], float(y[i]), float(y[i]) * 1.5)
         for i in range(len(y))]
    r = [RSample(s.graph, s.op, s.dim, s.config, s.features, s.measured,
                 s.priced) for s in t]
    return t, r


def test_fit_equals_reference():
    t_s, r_s = _synthetic_samples(3)
    t, r = tc.fit(t_s, meta={"scale": "x"}), rc.fit(r_s, meta={"scale": "x"})
    assert set(t.coef) == set(r.coef) == {"spmm", "sddmm"}
    for op in r.coef:
        np.testing.assert_allclose(t.coefficients(op), r.coefficients(op),
                                   rtol=RTOL, atol=0)
        for k in ("rho_pre", "rho_post"):
            np.testing.assert_allclose(t.meta["diagnostics"][op][k],
                                       r.meta["diagnostics"][op][k],
                                       rtol=RTOL)
    np.testing.assert_allclose(t.predict(t_s), r.predict(r_s), rtol=RTOL)


def test_artifact_round_trip_both_ways(tmp_path):
    t_s, r_s = _synthetic_samples(4)
    t, r = tc.fit(t_s), rc.fit(r_s)
    t.save(tmp_path / "port.json")
    r.save(tmp_path / "ref.json")
    r_back = rc.CalibrationResult.load(tmp_path / "port.json")
    t_back = tc.CalibrationResult.load(tmp_path / "ref.json")
    for op in ("spmm", "sddmm", "gat"):       # gat falls back to spmm
        np.testing.assert_array_equal(r_back.coefficients(op),
                                      t.coefficients(op))
        np.testing.assert_array_equal(t_back.coefficients(op),
                                      r.coefficients(op))
    assert json.loads((tmp_path / "port.json").read_text())["columns"] == \
        list(rc.COLUMNS)
    bad = t.to_dict()
    bad["columns"] = ["const", "bytes"]
    with pytest.raises(ValueError, match="columns"):
        tc.CalibrationResult.from_dict(bad)


def test_stream_seconds_falls_back_to_the_memory_rate():
    cal = tc.CalibrationResult(coef={"spmm": dict.fromkeys(tc.COLUMNS,
                                                           0.0)})
    assert cal.stream_seconds(1e9, hbm_bw=2e9) == 0.5
    assert cal.stream_seconds(1e9) == 1e9 / tcm.H100.hbm_bw
    ref = rc.CalibrationResult(coef=cal.coef)
    assert cal.stream_seconds(3e6, hbm_bw=rcm.HBM_BW) == \
        ref.stream_seconds(3e6)


@pytest.mark.parametrize("name", ["rmat10", "grid32", "sbm8x64"])
def test_cpu_artifact_prices_as_the_reference(name):
    rg = next(g for g in ref_corpus("small") if g.name == name)
    g = next(g for g in corpus("small") if g.name == name)
    r_cal = rc.CalibrationResult.load(CPU_ARTIFACT)
    t_cal = tc.CalibrationResult.load(CPU_ARTIFACT)
    assert t_cal.meta == r_cal.meta
    rm = rcm.CostModel(rg.csr, calibration=r_cal)
    tm = tcm.CostModel(g.csr, REF_HW, calibration=t_cal)
    un_r, un_t = rcm.CostModel(rg.csr), tcm.CostModel(g.csr, REF_HW)
    for dim in (32, 64, 200):
        for H in (1, 4):
            for op in ("spmm", "sddmm", "gat"):
                for cfg in rc.config_space(dim):
                    c = _port_cfg(cfg)
                    for fused, epi in ((True, False), (False, False),
                                       (True, True), (False, True)):
                        if epi and op != "spmm":
                            continue
                        kw = dict(H=H, fused=fused, epilogue=epi)
                        assert tm.time(dim, c, op, **kw) == \
                            rm.time(dim, cfg, op, **kw), (cfg, op, kw)
                        assert un_t.time(dim, c, op, **kw) == \
                            un_r.time(dim, cfg, op, **kw), (cfg, op, kw)
                for fused in (True, False):
                    space = rc.config_space(dim)
                    r_best = rm.best(dim, space, op, H=H, fused=fused)
                    t_best = tm.best(dim, [_port_cfg(c) for c in space], op,
                                     H=H, fused=fused)
                    assert t_best[0].astuple() == r_best[0].astuple()
                    assert t_best[1] == r_best[1]


def test_h100_artifact_loads_and_names_the_card():
    cal = tc.CalibrationResult.load(H100_ARTIFACT)
    d = json.loads(H100_ARTIFACT.read_text())
    assert d["columns"] == list(tc.COLUMNS)
    assert set(cal.coef) == {"spmm", "sddmm"}
    for op, c in cal.coef.items():
        assert list(c) and set(c) == set(tc.COLUMNS)
        assert all(v >= 0 and np.isfinite(v) for v in c.values()), op
    meta = cal.meta
    assert meta["backend"] == "cuda" and "H100" in meta["device"]
    assert "W" in meta["nvidia_smi"]           # name, power limit
    assert "no host dispatch" in meta["timing"]  # device time only
    assert set(meta["diagnostics"]) == {"spmm", "sddmm"}
    assert meta["scale"] == "large" and meta["dims"] == [32, 64]
    # a calibrated cost model prices and picks with it
    g = next(g for g in corpus("small") if g.name == "rmat10")
    cm = tcm.CostModel.from_calibration(g.csr, H100_ARTIFACT)
    cfg, t = cm.best(64, tc.config_space(64))
    assert t > 0 and np.isfinite(t) and cfg in tc.config_space(64)


def test_core_exports_follow_reference():
    import repro.core
    import repro_torch.core
    # the dynamic-graph governor's re-pack prices wait for its port
    waiting = {"degraded_kernel_cost", "pack_setup_seconds"}
    assert set(repro.core.__all__) - waiting <= set(repro_torch.core.__all__)
