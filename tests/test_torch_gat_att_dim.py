"""GAT with an attention width apart from the message width: ``init_gat(...,
att_dim=)`` projects ``wq``/``wk`` into ``heads·att_dim`` and ``wv`` into
``heads·dv`` (the reference's ``init_gat(key, dims, att_dim=)``).

* The layout of the parameters equals the reference's at 1 and 4 heads.
* The whole model's forward and every parameter's gradient, at
  ``att_dim=8`` and ``dv=16`` per head, against the reference's
  ``gat_forward`` through its ``make_gat_message_fn`` on both backends
  (``"engine"``, and ``"pallas"`` in interpret mode), on the same numpy
  weights: the forward at ``test_torch_gat.py``'s ``atol=1e-5``, the
  gradients at ``test_torch_autograd.py``'s ``atol=1e-5`` scaled by
  each leaf's largest magnitude (a parameter's gradient sums over every
  node).
* Each of the three kernels' wrappers gets the width it should: the
  SDDMM → softmax stats Q·K at ``att_dim`` with the scale ``1/√att_dim``,
  the softmax prologue at ``dv``, the raw SDDMM (dα) at ``dv``, dQ and dK
  at ``att_dim``, dVf at ``dv`` — through ``train_gnn``'s steps.
* Serving (``GNNService``) against the reference's service and the port's
  own unbucketed forward; the partitioned ``dist_gat`` on 2 CPU ranks
  against one device, forward and gradients, at 1 and 4 heads (the joint
  ``[K | Vf]`` halo exchange carries two widths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cost_model as rcm
from repro.core import engine as rengine
from repro.core import pcsr as rp
from repro.data.graphs import rmat as r_rmat
from repro.models.gnn import gat_forward as r_gat_forward
from repro.models.gnn import init_gat as r_init_gat
from repro.serve import GNNService as RService
from repro.serve import replay as r_replay
from repro.serve import synthetic_stream as r_stream

from repro_torch.convert import params_to_torch
from repro_torch.core import pcsr as tp
from repro_torch.core.cost_model import Hardware
from repro_torch.core.engine import make_gat_message_fn
from repro_torch.data.graphs import rmat as t_rmat
from repro_torch.models.gnn import gat_forward, init_gat

from conftest import random_csr

ATT = 8
DIMS = {1: [8, 16, 16, 4], 4: [8, 64, 64, 4]}   # dv = 16 a head when hidden
ATOL = 1e-5
REF_HW = Hardware(hbm_bw=rcm.HBM_BW, flops=rcm.VPU_FLOPS,
                  step_overhead=rcm.STEP_OVERHEAD,
                  chunk_setup=rcm.CHUNK_SETUP, dtype_bytes=rcm.DTYPE_BYTES)


def _graph(seed=3, n=40):
    from repro.core.sparse import CSRMatrix
    rng = np.random.default_rng(seed)
    _, A = random_csr(rng, n, density=0.12, skew=True)
    A[5:12] = 0.0                                  # rows without edges
    return CSRMatrix.from_dense(A)


def _np_params(heads, dims=None, seed=0):
    return jax.tree_util.tree_map(np.asarray, r_init_gat(
        jax.random.PRNGKey(seed), dims or DIMS[heads], att_dim=ATT,
        heads=heads))


@pytest.mark.parametrize("heads", [1, 4])
def test_init_gat_att_dim_layout_matches_reference(heads):
    ref = _np_params(heads)
    got = init_gat(DIMS[heads], generator=torch.Generator().manual_seed(0),
                   heads=heads, att_dim=ATT)
    for a, b in zip(ref, got):
        assert a.keys() == b.keys()
        for k in a:
            assert tuple(a[k].shape) == tuple(b[k].shape), k
    assert got[0]["wq"].shape[1] == got[0]["wk"].shape[1] == heads * ATT
    assert got[0]["wv"].shape[1] == 16 * heads


def _flat_grads(grads):
    return [np.asarray(g[k]) for g in grads for k in sorted(g)]


@pytest.mark.parametrize("backend", ["engine", "pallas"])
@pytest.mark.parametrize("heads", [1, 4])
def test_att_dim_forward_and_grads_match_reference(heads, backend):
    cfg = tp.SpMMConfig(V=2, S=True, W=8)
    csr = _graph()
    args = (csr.indptr, csr.indices, csr.data, csr.n_rows, csr.n_cols)
    r = rp.build_pcsr(*args, rp.SpMMConfig(V=2, S=True, W=8))
    t = tp.build_pcsr(*args, cfg)
    np_params = _np_params(heads)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((csr.n_rows, 8)).astype(np.float32)
    G = rng.standard_normal((csr.n_rows, 4)).astype(np.float32)
    r_msg = rengine.make_gat_message_fn(r, rp.transpose_pcsr(r),
                                        backend=backend, interpret=True)

    def r_loss(p):
        out = r_gat_forward(p, jnp.asarray(X), r_msg, heads=heads)
        return jnp.sum(out * G), out

    (_, want), r_grads = jax.jit(jax.value_and_grad(r_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    params = params_to_torch(np_params)
    for layer in params:
        for v in layer.values():
            v.requires_grad_()
    out = gat_forward(params, torch.from_numpy(X),
                      make_gat_message_fn(t, tp.transpose_pcsr(t)),
                      heads=heads)
    (out * torch.from_numpy(G)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    got = [v.grad.numpy() for layer in params for k, v in
           sorted(layer.items())]
    for g, w in zip(got, _flat_grads(r_grads)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("heads", [1, 4])
def test_kernels_run_at_both_widths_through_train_gnn(heads, monkeypatch):
    """Every call of the three kernels' wrappers on ``train_gnn``'s
    steps, by the width of its dense operand."""
    from repro_torch.apps.gnn import train_gnn
    from repro_torch.data.tasks import community_task
    from repro_torch.kernels.paramspmm import ops
    from repro_torch.kernels.sddmm import ops as sops
    seen = {"stats": set(), "scale": set(), "spmm_prologue": set(),
            "spmm_vals": set(), "raw": set()}
    stats, spmm, raw = sops._stats_call, ops._call, sops._call

    def stats_spy(steer, Q, K_mat, **kw):
        seen["stats"].add((Q.shape[-1], K_mat.shape[-1]))
        seen["scale"].add(kw["scale"])
        return stats(steer, Q, K_mat, **kw)

    def spmm_spy(steer, B, **kw):
        key = "spmm_prologue" if kw.get("rowmax") is not None else \
            "spmm_vals"
        seen[key].add(B.shape[-1])
        return spmm(steer, B, **kw)

    def raw_spy(steer, Q, K_mat, **kw):
        seen["raw"].add((Q.shape[-1], K_mat.shape[-1]))
        return raw(steer, Q, K_mat, **kw)

    monkeypatch.setattr(sops, "_stats_call", stats_spy)
    monkeypatch.setattr(ops, "_call", spmm_spy)
    monkeypatch.setattr(sops, "_call", raw_spy)
    task = community_task(n_blocks=4, block_size=16, feat_dim=8, seed=1)
    dims = [8] + DIMS[heads][1:-1] + [task.n_classes]
    params = params_to_torch(_np_params(heads, dims))
    res = train_gnn(task, model="gat", hidden=dims[1], n_layers=3, steps=3,
                    heads=heads, params=params, device="cpu")
    assert np.isfinite(res.losses).all() and len(res.losses) == 3
    dv = 16                               # a hidden layer's head
    assert seen["stats"] == {(ATT, ATT)}
    assert seen["scale"] == {float(1.0 / np.sqrt(ATT))}
    # the prologue at every layer's dv; dVf on dOut, also at dv
    assert seen["spmm_prologue"] == {dv, task.n_classes}
    # dQ, dK at att_dim (on K and Q), dVf at dv (on dOut)
    assert seen["spmm_vals"] == {ATT, dv, task.n_classes}
    assert seen["raw"] == {(dv, dv), (task.n_classes, task.n_classes)}


def test_service_with_att_dim_matches_reference_service():
    from repro_torch.serve import GNNService, reference_forward, replay
    from repro_torch.serve import synthetic_stream
    g_r, g_t = r_rmat(10, 6, seed=4), t_rmat(10, 6, seed=4)
    g_r.data = np.ones_like(g_r.data)
    g_t.data = np.ones_like(g_t.data)
    feats = np.random.default_rng(4).integers(0, 3, (g_r.n_rows, 8)) \
        .astype(np.float32)
    np_params = _np_params(1)
    ref = RService(g_r, feats, np_params, model="gat", backend="engine")
    port = GNNService(g_t, feats, params_to_torch(np_params), model="gat",
                      device="cpu", hardware=REF_HW, keep_subgraphs=True)
    want = r_replay(ref, r_stream(8, g_r.n_rows, seed=11), tick_every=3)
    got = replay(port, synthetic_stream(8, g_t.n_rows, seed=11),
                 tick_every=3)
    assert port.batch_log == ref.batch_log
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.rid == b.rid and a.config.astuple() == b.config.astuple()
        np.testing.assert_allclose(a.outputs, np.asarray(b.outputs),
                                   rtol=0, atol=ATOL)
        sr = a.sampled
        one = reference_forward(sr.sub, torch.from_numpy(feats[sr.nodes]),
                                port.params, model="gat", config=a.config)
        np.testing.assert_allclose(a.outputs, one.numpy()[sr.seed_local],
                                   rtol=0, atol=ATOL)


# ------------------------------------------------ partitioned, 2 ranks
def _dist_rank(csr_args, cases):
    from repro_torch.core.sparse import CSRMatrix
    from repro_torch.dist import DistGraph
    out = []
    for H, Q, K, Vf, G in cases:
        g = DistGraph(CSRMatrix(*csr_args), Vf.shape[-1], 2, op="gat",
                      heads=H, device="cpu", hardware=REF_HW)
        pad, unpad = (g.pad_heads, g.unpad_heads) if H > 1 else \
            (g.pad, g.unpad)
        q, k, v = (pad(torch.from_numpy(x)).requires_grad_()
                   for x in (Q, K, Vf))
        y = g.gat_message(q, k, v)
        y.backward(pad(torch.from_numpy(G)))
        out.append({"out": unpad(y).detach().numpy(),
                    "grads": [unpad(x.grad).numpy() for x in (q, k, v)]})
    return out


def test_dist_gat_with_att_dim_matches_one_device():
    """Q and K at ``att_dim`` = 8, Vf at 16 a head, 1 and 4 heads: the
    shards' message and its gradients against one device's at ATOL."""
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.sparse import CSRMatrix
    from repro_torch.dist import comm
    csr = _graph(seed=5, n=48)
    args = (csr.indptr, csr.indices, csr.data, csr.n_rows, csr.n_cols)
    rng = np.random.default_rng(6)
    n = csr.n_rows
    cases = []
    for H in (1, 4):
        lead = (H,) if H > 1 else ()
        Q, K = (rng.standard_normal(lead + (n, ATT)).astype(np.float32)
                for _ in range(2))
        Vf, G = (rng.standard_normal(lead + (n, 16)).astype(np.float32)
                 for _ in range(2))
        cases.append((H, Q, K, Vf, G))
    ranks = comm.spawn(_dist_rank, 2, (args, cases), backend="gloo",
                       device="cpu", threads=1)
    tcsr = CSRMatrix(*args)
    for (H, Q, K, Vf, G), got0, got1 in zip(cases, ranks[0], ranks[1]):
        cfg, _ = CostModel(tcsr, REF_HW).best(
            16, tp.config_space(16), op="gat", H=H)
        t = tp.build_pcsr(*args, cfg)
        xs = [torch.from_numpy(x).requires_grad_() for x in (Q, K, Vf)]
        y = make_gat_message_fn(t, tp.transpose_pcsr(t))(*xs)
        y.backward(torch.from_numpy(G))
        for got in (got0, got1):
            np.testing.assert_allclose(got["out"], y.detach().numpy(),
                                       rtol=0, atol=ATOL)
            for g, x in zip(got["grads"], xs):
                np.testing.assert_allclose(g, x.grad.numpy(), rtol=0,
                                           atol=ATOL)
