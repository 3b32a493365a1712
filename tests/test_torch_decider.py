"""PyTorch port vs JAX reference: the random-forest SpMM-decider.

Both packages' ``DecisionTree`` / ``RandomForest`` / ``SpMMDecider`` are
numpy; given the same samples and seed the port must grow the same trees
and give the same ``predict_proba``.  The samples here are the
decider's own: Table-3 features from each package's
``extract_features`` and labels from each package's model-mode
``oracle_search`` on ``corpus("small")`` (the port's priced with the
reference's constants, ``REF_HW``).  ``convert.decider_to_torch``
carries a reference-trained decider across by attribute.
"""
import functools
import pathlib

import numpy as np
import pytest

from repro.core import autotune as rat
from repro.core import decider as rd
from repro.core import features as rf
from repro.data.graphs import corpus as ref_corpus
from repro.pipeline import pick_config as ref_pick_config

from repro_torch.convert import decider_to_torch
from repro_torch.core import autotune as tat
from repro_torch.core.cost_model import CostModel
from repro_torch.core import decider as td
from repro_torch.core import features as tf
from repro_torch.core.pcsr import SpMMConfig
from repro_torch.data.graphs import corpus
from repro_torch.pipeline import pick_config

from test_torch_pcsr import REF_HW

DIMS = (16, 64, 128)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port_cfg(c):
    w, f, v, s, b = c.astuple()
    return SpMMConfig(V=v, S=s, F=f, W=w, B=b)


@functools.lru_cache(maxsize=None)
def _samples():
    """(reference samples, port samples): ``(features, dim, best)`` per
    graph of ``corpus("small")`` and dim of ``DIMS``."""
    ref, port = [], []
    for rg, g in zip(ref_corpus("small"), corpus("small")):
        rfeat, tfeat = rf.extract_features(rg.csr), tf.extract_features(g.csr)
        for dim in DIMS:
            rbest = rat.oracle_search(rg.csr, dim, mode="model").best_config
            tbest = tat.oracle_search(g.csr, dim, mode="model",
                                      cm=CostModel(g.csr, REF_HW)
                                      ).best_config
            assert tbest.astuple() == rbest.astuple(), (g.name, dim)
            ref.append((rfeat, dim, rbest))
            port.append((tfeat, dim, tbest))
    return ref, port


@functools.lru_cache(maxsize=None)
def _deciders(seed=0, n_estimators=12):
    ref_s, port_s = _samples()
    r = rd.SpMMDecider(forest=rd.RandomForest(n_estimators=n_estimators,
                                              seed=seed)).fit(ref_s)
    t = td.SpMMDecider(forest=td.RandomForest(n_estimators=n_estimators,
                                              seed=seed)).fit(port_s)
    return r, t


def _same_tree(r, t):
    if r.value is not None or t.value is not None:
        np.testing.assert_array_equal(t.value, r.value)
        return
    assert (t.feature, t.threshold) == (r.feature, r.threshold)
    _same_tree(r.left, t.left)
    _same_tree(r.right, t.right)


def _separable(seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((300, 6))
    y = (X[:, 2] > 0.3).astype(int) + 2 * (X[:, 4] > 0).astype(int)
    return X, y


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_equals_reference(seed):
    X, y = _separable(seed)
    kw = dict(max_depth=6, min_samples_leaf=2, max_features=3)
    r = rd.DecisionTree(rng=np.random.default_rng(seed), **kw).fit(X, y, 4)
    t = td.DecisionTree(rng=np.random.default_rng(seed), **kw).fit(X, y, 4)
    _same_tree(r.root, t.root)
    np.testing.assert_array_equal(t.predict_proba(X), r.predict_proba(X))


@pytest.mark.parametrize("seed", [0, 3])
def test_forest_equals_reference(seed):
    X, y = _separable(seed)
    r = rd.RandomForest(n_estimators=8, seed=seed).fit(X[:200], y[:200], 4)
    t = td.RandomForest(n_estimators=8, seed=seed).fit(X[:200], y[:200], 4)
    for rt, tt in zip(r.trees, t.trees):
        _same_tree(rt.root, tt.root)
    np.testing.assert_array_equal(t.predict_proba(X[200:]),
                                  r.predict_proba(X[200:]))
    np.testing.assert_array_equal(t.predict(X[200:]), r.predict(X[200:]))


def test_decider_on_oracle_labels_equals_reference():
    r, t = _deciders()
    ref_s, port_s = _samples()
    assert [c.astuple() for c in t.space] == [c.astuple() for c in r.space]
    Xr = np.stack([r.encode(f, d) for f, d, _ in ref_s])
    Xt = np.stack([t.encode(f, d) for f, d, _ in port_s])
    np.testing.assert_array_equal(Xt, Xr)
    np.testing.assert_array_equal(t.forest.predict_proba(Xt),
                                  r.forest.predict_proba(Xr))
    for (rfeat, dim, _), (tfeat, _, _) in zip(ref_s, port_s):
        for d in (dim, 200, 512):
            assert t.predict(tfeat, d).astuple() == \
                r.predict(rfeat, d).astuple()


def test_decider_masks_invalid_f():
    d = td.SpMMDecider()
    f = tf.MatrixFeatures(np.ones(len(tf.FEATURE_NAMES)))
    big_f = [c for c in d.space if c.F == 4][0]
    d.fit([(f, 512, big_f)] * 8)
    assert d.predict(f, 64).F == 1          # dim 64 → only F = 1 valid
    assert d.predict(f, 512) == big_f


def test_save_load_round_trip(tmp_path):
    _, t = _deciders()
    path = tmp_path / "decider.pkl"
    t.save(str(path))
    back = td.SpMMDecider.load(str(path))
    assert type(back) is td.SpMMDecider
    _, port_s = _samples()
    X = np.stack([t.encode(f, d) for f, d, _ in port_s])
    np.testing.assert_array_equal(back.forest.predict_proba(X),
                                  t.forest.predict_proba(X))
    assert back.space == t.space


def test_decider_to_torch_predicts_the_same_configs():
    r, t = _deciders(seed=1)
    c = decider_to_torch(r)
    assert type(c) is td.SpMMDecider
    ref_s, port_s = _samples()
    for (rfeat, dim, _), (tfeat, _, _) in zip(ref_s, port_s):
        np.testing.assert_array_equal(
            c.forest.predict_proba(c.encode(tfeat, dim)[None]),
            r.forest.predict_proba(r.encode(rfeat, dim)[None]))
        assert c.predict(tfeat, dim).astuple() == \
            r.predict(rfeat, dim).astuple()
    assert len(c.forest.trees) == len(r.forest.trees)
    for rt, ct in zip(r.forest.trees, c.forest.trees):
        _same_tree(rt.root, ct.root)


def test_pick_config_with_decider_agrees_with_reference():
    r, t = _deciders()
    for rg, g in zip(ref_corpus("small"), corpus("small")):
        for dim in (32, 64, 256):
            want = ref_pick_config(rg.csr, dim, decider=r)
            assert pick_config(g.csr, dim, decider=t).astuple() == \
                want.astuple()
            # the decider short-circuits every other branch
            assert pick_config(g.csr, dim, decider=t,
                               select="measured").astuple() == \
                want.astuple()


def test_decider_train_harness_equals_reference():
    """``apps/decider_train``: labels priced through the same calibration
    artifact (so the hardware constants do not enter), the by-graph
    split, the forest and its held-out quality all equal the
    reference's."""
    from repro.apps import decider_train as rdt
    from repro_torch.apps import decider_train as tdt
    cal = str(ROOT / "configs" / "calibration_cpu_host.json")
    kw = dict(dims=(16, 64, 256), mode="model", calibration=cal)
    r_ds = rdt.build_dataset(ref_corpus("small"), **kw)
    t_ds = tdt.build_dataset(corpus("small"), **kw)
    assert t_ds.graph_names == r_ds.graph_names
    assert t_ds.by_graph == r_ds.by_graph
    assert [c.astuple() for _, _, c in t_ds.samples] == \
        [c.astuple() for _, _, c in r_ds.samples]
    r_ev = rdt.train_eval(r_ds, seed=1, n_estimators=10)
    t_ev = tdt.train_eval(t_ds, seed=1, n_estimators=10)
    assert (t_ev.agreement, t_ev.mean_regret, t_ev.max_regret) == \
        (r_ev.agreement, r_ev.mean_regret, r_ev.max_regret)
    assert t_ev.per_dim == r_ev.per_dim
    assert t_ev.per_dim_quality == r_ev.per_dim_quality


def test_decider_train_cli_on_cpu(tmp_path, capsys):
    from repro_torch.apps.decider_train import main
    path = tmp_path / "decider.pkl"
    ev = main(["--device", "cpu", "--scale", "small", "--dims", "16,64",
               "--save", str(path), "--trace", str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    assert "overall:" in out and "device=cpu" in out
    assert 0.0 <= ev.agreement <= 1.0 and ev.mean_regret >= 1.0
    back = td.SpMMDecider.load(str(path))
    assert len(back.forest.trees) == len(ev.decider.forest.trees)
