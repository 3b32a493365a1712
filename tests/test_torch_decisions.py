"""PyTorch port vs JAX reference: the config-pick decision log and the
input-drift advisories (``obs/decisions.py``).

The same picks on the same graphs, traced in both packages, must leave
the same records (source, op, dim, heads, chosen, top-k, snapshot,
calibration id; only the wall time differs), and ``check_drift`` must
give the same verdict on the same mutated graph, under every way of
setting its thresholds.
"""
import json
import pathlib

import numpy as np
import pytest

from repro import obs as robs
from repro.core import calibrate as rc
from repro.core.cost_model import CostModel as RCostModel
from repro.core.decider import RandomForest as RForest
from repro.core.decider import SpMMDecider as RDecider
from repro.core.features import extract_features as r_features
from repro.core.pcsr import config_space as r_space
from repro.core.sparse import CSRMatrix as RCSR
from repro.obs import decisions as rdec

from repro_torch import obs as tobs
from repro_torch.convert import decider_to_torch
from repro_torch.core import calibrate as tc
from repro_torch.core.cost_model import CostModel as TCostModel
from repro_torch.core.features import extract_features as t_features
from repro_torch.core.pcsr import config_space as t_space
from repro_torch.core.sparse import CSRMatrix as TCSR
from repro_torch.obs import decisions as tdec

from conftest import random_csr
from test_torch_pcsr import REF_HW


def _pair(csr):
    return (RCSR(csr.indptr.copy(), csr.indices.copy(), csr.data.copy(),
                 csr.n_rows, csr.n_cols),
            TCSR(csr.indptr.copy(), csr.indices.copy(), csr.data.copy(),
                 csr.n_rows, csr.n_cols))


def _densified(csr, seed):
    A = csr.to_dense()
    rng = np.random.default_rng(seed)
    return RCSR.from_dense(A + (rng.random(A.shape) < 0.3).astype(
        np.float32))


def _record(rec):
    d = rec.to_dict()
    del d["walltime"]
    return d


def test_constants_equal_reference():
    assert tdec.DRIFT_FEATURES == rdec.DRIFT_FEATURES
    assert tdec.DRIFT_THRESHOLD == rdec.DRIFT_THRESHOLD
    assert tdec.DRIFT_THRESHOLD_ENV == rdec.DRIFT_THRESHOLD_ENV


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_graph_snapshot_equals_reference(seed):
    csr, _ = random_csr(np.random.default_rng(seed), 70, 0.06,
                        skew=seed == 1)
    r, t = _pair(csr)
    assert tdec.graph_snapshot(t) == rdec.graph_snapshot(r)


@pytest.mark.parametrize("calibrated", [False, True])
def test_cost_model_records_equal_reference(calibrated, tmp_path):
    csr, _ = random_csr(np.random.default_rng(3), 64, 0.1)
    r, t = _pair(csr)
    path = (pathlib.Path(__file__).resolve().parents[1] / "configs"
            / "calibration_cpu_host.json")
    r_cal = rc.CalibrationResult.load(path) if calibrated else None
    t_cal = tc.CalibrationResult.load(path) if calibrated else None
    with robs.tracing():
        RCostModel(r, calibration=r_cal).best(32, r_space(32), op="gat",
                                              H=4)
    with tobs.tracing(str(tmp_path / "t.json")):
        TCostModel(t, REF_HW, calibration=t_cal).best(32, t_space(32),
                                                      op="gat", H=4)
    [want], [got] = rdec.decision_log(), tdec.decision_log()
    assert _record(got) == _record(want)
    assert got.calibration == (None if not calibrated
                               else "sddmm+spmm@" + r_cal.meta["host"])
    payload = json.loads((tmp_path / "t.json").read_text())
    [d] = payload["repro_decisions"]
    assert d["chosen"] == list(got.chosen)
    assert payload["repro_metrics"]["decisions_total"] == {
        "op=gat,source=cost_model": 1.0}


def test_decider_records_equal_reference():
    rng = np.random.default_rng(4)
    samples = []
    for i in range(6):
        csr, _ = random_csr(rng, 40 + 10 * i, 0.08, skew=i % 2 == 0)
        samples.append((r_features(csr), 64, r_space(64)[i % 5]))
    ref = RDecider(forest=RForest(n_estimators=5, seed=0)).fit(samples)
    port = decider_to_torch(ref)
    csr, _ = random_csr(rng, 50, 0.1)
    r, t = _pair(csr)
    with robs.tracing():
        ref.predict(r_features(r), 64)
    with tobs.tracing():
        port.predict(t_features(t), 64)
    [want], [got] = rdec.decision_log(), tdec.decision_log()
    assert _record(got) == _record(want)
    assert got.source == "decider" and got.snapshot["n"] == 50.0


def test_log_survives_stop_and_clears_on_start():
    csr, _ = random_csr(np.random.default_rng(5), 32, 0.1)
    _, t = _pair(csr)
    with tobs.tracing():
        TCostModel(t).best(16, t_space(16))
    assert len(tdec.decision_log()) == 1
    with tobs.tracing():
        assert tdec.decision_log() == []
    tdec.clear_decisions()
    with pytest.raises(ValueError, match="no decision"):
        tdec.check_drift(t)
    # untraced picks record nothing
    TCostModel(t).best(16, t_space(16))
    assert tdec.decision_log() == []
    assert tdec.record_decision(t, source="x", dim=1, chosen=(1,)) is None


def test_record_decision_topk_equals_reference():
    space = [(8, 1, 1, False, False), (8, 2, 1, False, False),
             (16, 1, 2, True, False), (32, 1, 1, True, True)]
    kw = dict(source="decider", dim=64, chosen=space[1],
              snapshot={"n": 1.0}, k=2)
    with robs.tracing():
        want = rdec.record_decision(scores=zip(space, [0.2, 0.7, 0.1, 0.3]),
                                    **kw)
        want_c = rdec.record_decision(
            candidates=zip(space, [3.0, 1.0, 2.0, 0.5]), **kw)
    with tobs.tracing():
        got = tdec.record_decision(scores=zip(space, [0.2, 0.7, 0.1, 0.3]),
                                   **kw)
        got_c = tdec.record_decision(
            candidates=zip(space, [3.0, 1.0, 2.0, 0.5]), **kw)
    assert _record(got) == _record(want)
    assert _record(got_c) == _record(want_c)
    assert [c["score"] for c in got.topk] == [0.7, 0.3]


@pytest.mark.parametrize("threshold", [None, 0.5, 0.01, {"nnz": 100.0},
                                       {"nnz": 0.01, "cv": 2.0}])
def test_check_drift_equals_reference(threshold):
    csr, _ = random_csr(np.random.default_rng(6), 64, 0.05)
    r, t = _pair(csr)
    r2, t2 = _pair(_densified(csr, 7))
    with robs.tracing():
        RCostModel(r).best(32, r_space(32))
    with tobs.tracing():
        TCostModel(t).best(32, t_space(32))
    for rg, tg in ((r, t), (r2, t2)):
        want = rdec.check_drift(rg, threshold=threshold)
        got = tdec.check_drift(tg, threshold=threshold)
        assert (got is None) == (want is None)
        if want is not None:
            assert got.drifted == want.drifted
            assert got.message == want.message
    assert tdec.check_drift(t) is None


def test_resolve_drift_thresholds_equals_reference(monkeypatch):
    for spec in (None, 0.3, {"nnz": 0.05}):
        assert tdec.resolve_drift_thresholds(spec) == \
            rdec.resolve_drift_thresholds(spec)
    for env in ("0.4", "nnz=0.02, cv=1.5"):
        monkeypatch.setenv(tdec.DRIFT_THRESHOLD_ENV, env)
        assert tdec.resolve_drift_thresholds() == \
            rdec.resolve_drift_thresholds()
    with pytest.raises(ValueError, match="unknown drift feature"):
        tdec.resolve_drift_thresholds({"not_a_feature": 0.1})


def test_instant_events_are_exported(tmp_path):
    path = tmp_path / "i.json"
    with tobs.tracing(str(path)):
        tobs.instant("mark", where="here")
    tobs.instant("ignored")                    # tracing off: no-op
    events = json.loads(path.read_text())["traceEvents"]
    [e] = [e for e in events if e["name"] == "mark"]
    assert e["ph"] == "i" and e["args"] == {"where": "here"}
