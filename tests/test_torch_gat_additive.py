"""The published GAT (additive attention, Veličković et al., ICLR 2018) on
the port, held against the plain reference ``plain_gat_additive.py`` on
seeded random weights at the PPI model's shape cut small: widths [12, 32,
32, 7], heads [4, 4, 6] (4 heads of 8 concatenated twice, the identity
skip across the middle layer, 6 averaged heads of 7), 300 nodes.

Tolerances, and why:

* forward logits ``atol=1e-5`` and the loss ``rtol=1e-6``: the softmax
  sums and the aggregation run in another order than the reference's
  ``index_add_`` (float32 rounding of sums of ~10 terms of order 1);
* every leaf's gradient within ``1e-5`` × its largest magnitude: a
  parameter's gradient sums over every node and edge, so its rounding
  grows with the leaf's scale;
* ``train_gnn``'s losses over 3 AdamW steps ``rtol=1e-5``: the
  gradients' rounding, moved by Adam's normalised step.

The logits of the 2-wide route (``Q = [el, 1]``, ``K = [1, er]`` at
scale 1) equal the reference's ``el_i + er_j`` bit for bit, and the
dot-product GAT at its default scale gives the bits it gave before the
scale became a parameter.
"""
import numpy as np
import pytest
import torch

import plain_gat_additive as plain
from repro_torch.apps.gnn import train_gnn
from repro_torch.core.engine import make_gat_message_fn
from repro_torch.core.sparse import CSRMatrix
from repro_torch.data.tasks import NodeTask, community_task
from repro_torch.kernels.paramspmm.ops import device_steering
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.models.gnn import (additive_scores, gat_additive_forward,
                                    init_gat_additive, node_bce_loss,
                                    node_ce_loss)
from repro_torch.pipeline import ParamSpMM

DIMS = [12, 32, 32, 7]
HEADS = [4, 4, 6]
N = 300


def _graph(seed=1, n=N):
    """A symmetric binary graph without self loops, with two hubs."""
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)) < 0.02
    A[rng.integers(0, n, 2)] = rng.random((2, n)) < 0.4
    A = A | A.T
    np.fill_diagonal(A, False)
    rows, cols = np.nonzero(A)
    return CSRMatrix.from_coo(rows, cols, np.ones(rows.size, np.float32),
                              n, n)


def _task(seed=2):
    csr = _graph()
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, DIMS[0])).astype(np.float32)
    labels = (rng.random((N, DIMS[-1])) < 0.5).astype(np.float32)
    train = np.zeros(N, np.float32)
    train[rng.permutation(N)[:180]] = 1.0
    return NodeTask(csr, X, labels, train, 1.0 - train, DIMS[-1])


def _params(seed=3):
    return init_gat_additive(DIMS, HEADS,
                             generator=torch.Generator().manual_seed(seed))


def _pack(csr):
    return ParamSpMM(csr.gcn_normalize(), DIMS[1], op="gat", heads=HEADS[0],
                     reorder=False, device="cpu")


def _leaves(params):
    return [v.detach().clone().requires_grad_() for layer in params
            for v in layer.values()]


def _tree(leaves, like):
    it = iter(leaves)
    return [{k: next(it) for k in layer} for layer in like]


def test_forward_loss_and_gradients_match_the_plain_reference():
    task, p0 = _task(), _params()
    p = _pack(task.csr)
    msg = make_gat_message_fn(p.op.pcsr, p.op.pcsr_t, scale=1.0)
    X = torch.as_tensor(task.features)
    labels = torch.as_tensor(task.labels)
    mask = torch.as_tensor(task.train_mask)
    rows, cols = plain.edges(task.csr.indptr, task.csr.indices, N)

    mine, ref = _leaves(p0), _leaves(p0)
    out = gat_additive_forward(_tree(mine, p0), X, msg, HEADS)
    want = plain.forward(_tree(ref, p0), X, rows, cols)
    assert out.shape == (N, DIMS[-1])
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)

    loss = node_bce_loss(out, labels, mask)
    ref_loss = plain.loss(want, labels, mask)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-6, atol=0)
    g = torch.autograd.grad(loss, mine)
    rg = torch.autograd.grad(ref_loss, ref)
    names = [f"{i}.{k}" for i, layer in enumerate(p0) for k in layer]
    assert names == [f"{i}.{k}" for i in range(3)
                     for k in ("w", "al", "ar", "b")]
    for name, a, b in zip(names, g, rg):
        scale = float(b.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0,
                                   msg=lambda m: f"{name}: {m}")


def test_train_gnn_follows_the_reference_over_three_steps():
    task, p0 = _task(), _params()
    res = train_gnn(task, model="gat", attention="additive", heads=HEADS,
                    hidden=DIMS[1], n_layers=3, steps=3, lr=0.005,
                    params=p0, device="cpu")
    rows, cols = plain.edges(task.csr.indptr, task.csr.indices, N)
    losses, _, after = plain.train(
        p0, torch.as_tensor(task.features), torch.as_tensor(task.labels),
        torch.as_tensor(task.train_mask), rows, cols, 3, lr=0.005)
    np.testing.assert_allclose(res.losses, losses, rtol=1e-5)
    assert res.losses[2] < res.losses[0]
    assert 0.0 <= res.val_acc <= 1.0
    for mine, ref in zip(res.params, after):
        for k in ref:
            torch.testing.assert_close(mine[k], ref[k], atol=1e-4, rtol=0)


@pytest.mark.parametrize("heads", [1, 4, 6])
def test_two_wide_route_gives_the_reference_add_bit_for_bit(heads):
    """Q = [el, 1], K = [1, er] through the SDDMM → softmax stats at scale
    1: every real slot's logit is LeakyReLU(el_i + er_j) as the reference
    adds it, and α follows from the stats."""
    task = _task()
    p = _pack(task.csr)
    pc = p.op.pcsr
    gen = torch.Generator().manual_seed(heads)
    wh = torch.randn((N, heads, 9), generator=gen) * 3.0
    al, ar = torch.randn((heads, 9), generator=gen), \
        torch.randn((heads, 9), generator=gen)
    Q, K = additive_scores(wh, al, ar)
    assert Q.shape == K.shape == (heads, N, 2)
    logits, _, _ = sddmm_ops.sddmm_softmax_stats(pc, Q, K, scale=1.0)
    steer = device_steering(pc, Q.device)
    cfg = pc.config
    V, R, Kc = cfg.V, cfg.R, pc.K
    real = steer.vals != 0                                    # (C, V, K)
    C = steer.trow.shape[0]
    row = (steer.trow.long()[:, None, None] * R
           + steer.lrow.long().reshape(C, 1, Kc) * V
           + torch.arange(V)[None, :, None])
    col = steer.colidx.long().reshape(C, 1, Kc).expand(C, V, Kc)
    el, er = (wh * al).sum(-1).T, (wh * ar).sum(-1).T            # (H, n)
    want = plain.logits(el.T, er.T, row[real], col[real]).T       # (H, S)
    got = logits[:, real]
    assert got.shape == want.shape and want.shape[1] == pc.nnz
    assert torch.equal(got, want)


def test_dot_product_gat_keeps_its_bits_at_the_default_scale():
    """The dot-product GAT's losses and parameters after 3 steps on the
    CPU, as the port gave them before the logit scale became an option
    (float hex)."""
    t = community_task(n_blocks=4, block_size=48, feat_dim=16, seed=3)
    r = train_gnn(t, model="gat", hidden=64, n_layers=2, steps=3, heads=8,
                  device="cpu", lr=0.01, seed=5)
    assert [x.hex() for x in r.losses] == [
        '0x1.98ab720000000p+0', '0x1.0898d00000000p+0',
        '0x1.48f7b00000000p-1']
    assert [float(v.double().sum()).hex() for layer in r.params
            for v in layer.values()] == [
        '0x1.47daf3d1c0000p+3', '0x1.b5e4a61ba0000p+0',
        '-0x1.bbef79eac0000p+2', '0x1.956811d000000p-3',
        '-0x1.aa783d2a00000p+3', '-0x1.2b9f2aaa00000p+0',
        '-0x1.310a6df7f0000p+4', '-0x1.ae04600000000p-9']


@pytest.mark.parametrize("kw, err", [
    (dict(model="gcn", attention="additive"), ValueError),
    (dict(model="gat", heads=[2, 2]), ValueError),
    (dict(model="gat", attention="cosine"), ValueError),
    (dict(model="gat", attention="additive", heads=[2, 2, 2]), ValueError),
    (dict(model="gat", attention="additive", heads=2, partitions=2),
     NotImplementedError),
    (dict(model="gat", attention="additive", heads=3), ValueError),
    (dict(model="gcn", partitions=2), NotImplementedError),
])
def test_train_gnn_refuses_options_that_do_not_go_together(kw, err):
    with pytest.raises(err):
        train_gnn(_task(), hidden=8, n_layers=2, steps=1, device="cpu", **kw)


def test_bce_loss_needs_multi_hot_labels():
    """The labels pick the loss: multi-hot ``(n, C)`` labels train on the
    sigmoid cross-entropy, class ids ``(n,)`` on the softmax one."""
    task, p0 = _task(), _params()
    rows, cols = plain.edges(task.csr.indptr, task.csr.indices, N)
    want = plain.forward(p0, torch.as_tensor(task.features), rows, cols)
    mask = torch.as_tensor(task.train_mask)
    ids = np.argmax(task.labels, axis=1).astype(np.int32)
    for labels, expected in (
            (task.labels, plain.loss(want, torch.as_tensor(task.labels),
                                     mask)),
            (ids, node_ce_loss(want, torch.as_tensor(ids).long(), mask))):
        t = NodeTask(task.csr, task.features, labels, task.train_mask,
                     task.val_mask, DIMS[-1])
        res = train_gnn(t, model="gat", attention="additive", heads=HEADS,
                        hidden=DIMS[1], n_layers=3, steps=1, params=p0,
                        device="cpu")
        np.testing.assert_allclose(res.losses[0], float(expected),
                                   rtol=1e-6)
