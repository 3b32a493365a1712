"""PyTorch port vs JAX reference: the SpMM baselines of paper §6.1.

The cuSPARSE analogue (``torch.sparse.mm`` on a CSR tensor) and the
GE-SpMM analogue (row-wise gather + ``index_add_``) compute the
reference's ``make_cusparse_analog`` / ``make_gespmm_analog``: bit-exact
with integer-valued operands (every partial sum is an exact integer in
float32), within ``rtol=atol=1e-5`` with float operands.  Both are
differentiable in B, and ``train_gnn`` through them follows the
reference's loss trajectory within ``rtol=1e-4``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.apps.gnn import train_gnn as r_train_gnn
from repro.core import baselines as rb
from repro.core.sparse import CSRMatrix as RCSR
from repro.data.tasks import community_task as r_community_task
from repro.models import gnn as rgnn

from repro_torch.apps.gnn import build_spmm, train_gnn
from repro_torch.convert import params_to_torch
from repro_torch.core import baselines as tb
from repro_torch.core.sparse import CSRMatrix as TCSR
from repro_torch.data.tasks import community_task

from conftest import random_csr

TASK = dict(n_blocks=4, block_size=32, feat_dim=16, p_in=0.2, seed=5)
MAKERS = {"cusparse": (rb.make_cusparse_analog, tb.make_cusparse_analog),
          "gespmm": (rb.make_gespmm_analog, tb.make_gespmm_analog)}


def _pair(integer, seed, n=70, dim=24):
    rng = np.random.default_rng(seed)
    csr, _ = random_csr(rng, n, density=0.06, skew=True)
    data = csr.data
    if integer:
        data = rng.integers(-3, 4, data.shape).astype(np.float32)
    r = RCSR(csr.indptr.copy(), csr.indices.copy(), data.copy(), n, n)
    t = TCSR(csr.indptr.copy(), csr.indices.copy(), data.copy(), n, n)
    B = (rng.integers(-8, 9, (n, dim)) if integer
         else rng.standard_normal((n, dim))).astype(np.float32)
    return r, t, B


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("mode", sorted(MAKERS))
def test_analogue_equals_reference(mode, integer):
    r_make, t_make = MAKERS[mode]
    for seed in range(3):
        r, t, B = _pair(integer, seed)
        want = np.asarray(r_make(r)(B))
        got = t_make(t, "cpu")(torch.from_numpy(B)).numpy()
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, t.to_dense() @ B, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", sorted(MAKERS))
def test_analogue_gradient_is_the_transpose_product(mode):
    _, t, B = _pair(True, 7)
    fn = MAKERS[mode][1](t, "cpu")
    Bt = torch.from_numpy(B).requires_grad_()
    dC = torch.from_numpy(np.random.default_rng(8).integers(
        -4, 5, B.shape).astype(np.float32))
    (dB,) = torch.autograd.grad(fn(Bt), Bt, dC)
    np.testing.assert_array_equal(dB.numpy(), t.to_dense().T @ dC.numpy())


def test_analogues_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t, _ = _pair(True, 0)
    for make in (tb.make_cusparse_analog, tb.make_gespmm_analog):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(t)


@pytest.mark.parametrize("dim", [16, 64, 128, 200, 512, 1000])
def test_static_configs_equal_reference(dim):
    assert tb.gnnadvisor_config(dim).astuple() == \
        rb.gnnadvisor_config(dim).astuple()
    assert [c.astuple() for c in tb.daspmm_space(dim)] == \
        [c.astuple() for c in rb.daspmm_space(dim)]


def test_gnnadvisor_analogue_runs_at_its_config():
    r, t, B = _pair(False, 2, dim=64)
    op, cfg = tb.make_gnnadvisor_analog(t, 64, "cpu")
    r_fn, r_cfg = rb.make_gnnadvisor_analog(r, 64)
    assert cfg.astuple() == r_cfg.astuple() == op.config.astuple()
    np.testing.assert_allclose(op(torch.from_numpy(B)).numpy(),
                               np.asarray(r_fn(B)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["cusparse", "gespmm"])
def test_train_through_the_baseline_follows_reference(mode):
    r_task, t_task = r_community_task(**TASK), community_task(**TASK)
    hidden, layers, steps = 32, 2, 3
    dims = [t_task.features.shape[1], hidden, t_task.n_classes]
    params = jax.tree_util.tree_map(
        np.asarray, rgnn.init_gcn(jax.random.PRNGKey(0), dims))
    want = r_train_gnn(r_task, model="gcn", hidden=hidden, n_layers=layers,
                       steps=steps, spmm_mode=mode)
    got = train_gnn(t_task, model="gcn", hidden=hidden, n_layers=layers,
                    steps=steps, spmm_mode=mode,
                    params=params_to_torch(params), device="cpu")
    assert got.config is None and want.config is None
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=0)
    assert got.losses[-1] < got.losses[0]
    assert got.val_acc == want.val_acc


@pytest.mark.parametrize("kw", [{"config": None}, {"reorder": False},
                                {"decider": None}])
@pytest.mark.parametrize("mode", ["cusparse", "gespmm"])
def test_baseline_rejects_paramspmm_keywords(mode, kw):
    task = community_task(**TASK)
    with pytest.raises(ValueError, match="device only"):
        build_spmm(task, 16, mode, device="cpu", **kw)
    with pytest.raises(ValueError, match="device only"):
        train_gnn(task, model="gcn", hidden=16, n_layers=2, steps=1,
                  spmm_mode=mode, spmm_kwargs=kw, device="cpu")
    fn, perm, cfg = build_spmm(task, 16, mode, device="cpu")
    assert perm is None and cfg is None
