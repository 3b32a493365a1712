"""PyTorch port vs JAX reference: the GAT slice.

The port's GAT message (``core.engine.make_gat_message_fn``: the fused
SDDMM → softmax-stats operator, then the ParamSpMM softmax prologue; on
CPU tensors the kernels' plain versions) runs ``gat_forward`` on the
reference's parameters (carried across by ``params_to_torch``) and is held
against the reference's ``make_gat_message_fn`` on both of its backends
(``"engine"``, and ``"pallas"`` in interpret mode) at ``atol=1e-5``, for
1 and 4 heads.  The cost model's SDDMM and GAT-pair prices and picks
equal the reference's under its constants.  The serving tier end to end
is in ``test_torch_serve.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cost_model as rcm
from repro.core import engine as rengine
from repro.core import pcsr as rp
from repro.models.gnn import gat_forward as r_gat_forward
from repro.models.gnn import init_gat as r_init_gat

from repro_torch.convert import params_to_torch
from repro_torch.core import cost_model as tcm
from repro_torch.core import pcsr as tp
from repro_torch.core.engine import make_gat_message_fn
from repro_torch.core.sparse import CSRMatrix as TCSR
from repro_torch.kernels.paramspmm import ops as pops
from repro_torch.kernels.sddmm import ops as sops
from repro_torch.models.gnn import gat_forward, init_gat

from conftest import random_csr

DIMS = [8, 16, 16, 4]
ATOL = 1e-5
REF_HW = tcm.Hardware(hbm_bw=rcm.HBM_BW, flops=rcm.VPU_FLOPS,
                      step_overhead=rcm.STEP_OVERHEAD,
                      chunk_setup=rcm.CHUNK_SETUP,
                      dtype_bytes=rcm.DTYPE_BYTES)


def _graph(seed, n=40):
    rng = np.random.default_rng(seed)
    csr, A = random_csr(rng, n, density=0.12, skew=True)
    A[5:12] = 0.0                                  # rows without edges
    from repro.core.sparse import CSRMatrix
    return CSRMatrix.from_dense(A)


def _pair(csr, cfg):
    args = (csr.indptr, csr.indices, csr.data, csr.n_rows, csr.n_cols)
    rcfg = rp.SpMMConfig(V=cfg.V, S=cfg.S, F=cfg.F, W=cfg.W, B=cfg.B)
    return rp.build_pcsr(*args, rcfg), tp.build_pcsr(*args, cfg)


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("backend", ["engine", "pallas"])
def test_gat_forward_matches_reference(heads, backend):
    cfg = tp.SpMMConfig(V=2, S=True, W=8)
    csr = _graph(heads)
    r, t = _pair(csr, cfg)
    np_params = jax.tree_util.tree_map(
        np.asarray, r_init_gat(jax.random.PRNGKey(heads), DIMS, heads=heads))
    X = np.random.default_rng(0).standard_normal(
        (csr.n_rows, DIMS[0])).astype(np.float32)
    r_msg = rengine.make_gat_message_fn(r, backend=backend, interpret=True)
    want = np.asarray(r_gat_forward(np_params, jnp.asarray(X), r_msg,
                                    heads=heads))
    launches = (pops.launch_count(), sops.launch_count())
    got = gat_forward(params_to_torch(np_params), torch.from_numpy(X),
                      make_gat_message_fn(t), heads=heads).numpy()
    assert (pops.launch_count(), sops.launch_count()) == launches
    assert got.shape == want.shape == (csr.n_rows, DIMS[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_message_fn_is_forward_only():
    """The serving closure (``gat_message_fn`` without a transpose) is
    forward only: its backward raises.  ``make_gat_message_fn`` has the
    backward (held against the reference in ``test_torch_autograd.py``),
    and under ``no_grad`` records nothing."""
    from repro_torch.core.engine import gat_message_fn
    cfg = tp.SpMMConfig(V=1, S=True, W=8)
    csr = _graph(0)
    _, t = _pair(csr, cfg)
    Q = torch.ones((csr.n_rows, 4))
    serve = gat_message_fn(pops.device_steering(t, "cpu"), t)
    Qg = Q.clone().requires_grad_()
    with pytest.raises(ValueError, match="backward needs the transpose"):
        serve(Qg, Q, Q).sum().backward()
    f = make_gat_message_fn(t)
    f(Qg, Q, Q).sum().backward()
    assert Qg.grad is not None and bool(torch.isfinite(Qg.grad).all())
    with torch.no_grad():
        w = torch.ones((4, 4), requires_grad=True)
        assert not f(Q @ w, Q, Q).requires_grad


@pytest.mark.parametrize("heads", [1, 4])
def test_init_gat_layout_matches_reference(heads):
    ref = r_init_gat(jax.random.PRNGKey(0), DIMS, heads=heads)
    got = init_gat(DIMS, generator=torch.Generator().manual_seed(0),
                   heads=heads)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert a.keys() == b.keys()
        for k in a:
            assert tuple(a[k].shape) == tuple(b[k].shape), k
            assert b[k].dtype == torch.float32
    with pytest.raises(ValueError, match="divisible"):
        init_gat([8, 10, 4], generator=torch.Generator(), heads=4)
    carried = params_to_torch(jax.tree_util.tree_map(np.asarray, ref))
    for a, b in zip(ref, carried):
        for k in a:
            assert np.array_equal(np.asarray(a[k]), b[k].numpy())


@pytest.mark.parametrize("H", [1, 4])
def test_cost_model_sddmm_and_gat_match_reference(H):
    rng = np.random.default_rng(3)
    rcsr, _ = random_csr(rng, 90, density=0.04, skew=True)
    tcsr = TCSR(rcsr.indptr, rcsr.indices, rcsr.data, rcsr.n_rows,
                rcsr.n_cols)
    rmodel, tmodel = rcm.CostModel(rcsr), tcm.CostModel(tcsr, REF_HW)
    space_r, space_t = rp.config_space(64), tp.config_space(64)
    for rc, tc in zip(space_r, space_t):
        assert vars(rmodel.cost(64, rc, "sddmm", H=H)) == \
            vars(tmodel.cost(64, tc, "sddmm", H=H))
        for op in ("sddmm", "gat"):
            assert rmodel.time(64, rc, op, H=H) == tmodel.time(64, tc, op,
                                                               H=H)
    r_cfg, r_t = rmodel.best(64, space_r, op="gat", H=H)
    t_cfg, t_t = tmodel.best(64, space_t, op="gat", H=H)
    assert t_cfg.astuple() == r_cfg.astuple() and t_t == r_t


def test_serve_gnn_cli_gat_cpu_check(tmp_path):
    from repro_torch.apps.serve_gnn import main
    stats = main(["--device", "cpu", "--model", "gat", "--graph", "grid128",
                  "--requests", "4", "--tick-every", "2", "--check",
                  "--stats", str(tmp_path / "s.json")])
    assert stats["model"] == "gat" and stats["checked"] == 4
    assert stats["kernel_launches"] == 0 and stats["cache_hits"] > 0
