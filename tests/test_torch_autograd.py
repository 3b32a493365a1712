"""PyTorch port vs JAX reference: the training operators.

* Transposes: ``transpose_csr``, ``transpose_pcsr`` and
  ``slot_transfer_map`` equal the reference's array for array over all
  18 configs of ``config_space(64)`` and three graph kinds.
* The raw SDDMM (``sddmm`` on CPU tensors: the CUDA kernel's plain
  version ``sddmm_plain``) equals the reference's Pallas ``sddmm`` in
  interpret mode and ``sddmm_slots_ref`` bit for bit on integer operands
  (``atol=1e-5`` on float ones); every slot without a stored nonzero is 0.
* Gradients of ``make_spmm_fn`` and ``make_fused_spmm_fn`` (every
  activation, with bias, residual and scale) equal ``jax.vjp`` through
  the reference's ``custom_vjp`` on its engine backend: bit-exact on
  integer operands, ``atol=1e-5`` on float ones.
* GAT message gradients (dQ, dK, dVf) at 1 and 4 heads match the
  reference's Pallas-interpret ``custom_vjp`` and its engine's autodiff
  at ``atol=1e-5``, on a graph with rows without edges, explicit zeros,
  and a row whose logits are all zero.
* The GAT backward's softmax-vjp row sum Σ_j α_ij·dα_ij, taken as
  dOut_i·out_i (``_row_dot``), equals the ``index_add_`` over each row's
  slots that it replaced at ``atol=1e-5``, and gives the same bits twice.
The graphs stay ≤ ~60 nodes where the reference runs Pallas in interpret
mode.  On CPU tensors nothing is launched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as rengine
from repro.core import pcsr as rp
from repro.core.sparse import CSRMatrix as RCSR
from repro.kernels.sddmm import ops as rsops
from repro.kernels.sddmm.ref import sddmm_slots_ref as r_slots_ref

from repro_torch.core import engine as tengine
from repro_torch.core import pcsr as tp
from repro_torch.core.sparse import CSRMatrix as TCSR
from repro_torch.kernels.paramspmm import ops as pops
from repro_torch.kernels.sddmm import ops as sops
from repro_torch.kernels.sddmm.ref import sddmm_dense_ref, sddmm_slots_ref

from conftest import random_csr

FIELDS = ("colidx", "lrow", "trow", "init", "fini", "vals")
ATOL = 1e-5
SMALL = [tp.SpMMConfig(V=v, S=s, B=b, W=r // v)
         for v in (1, 2) for (s, b) in ((False, False), (True, False),
                                        (True, True))
         for r in (8, 16)]


def _rcfg(cfg):
    return rp.SpMMConfig(V=cfg.V, S=cfg.S, F=cfg.F, W=cfg.W, B=cfg.B)


def _tcfg(cfg):
    return tp.SpMMConfig(V=cfg.V, S=cfg.S, F=cfg.F, W=cfg.W, B=cfg.B)


def _graph(kind: str, n=56, integer=False):
    """A reference CSR: ``skewed`` (hub rows), ``empty`` (whole blocks of
    rows without an edge, explicit zeros stored as edges) or ``rect``
    (non-square)."""
    rng = np.random.default_rng({"skewed": 0, "empty": 1, "rect": 2}[kind])
    if kind == "rect":
        A = ((rng.random((n, n + 13)) < 0.1)
             * rng.standard_normal((n, n + 13))).astype(np.float32)
    else:
        _, A = random_csr(rng, n, density=0.08, skew=kind == "skewed")
        if kind == "empty":
            A[10:34] = 0.0
    if integer:
        A = np.round(A * 2)
    rows, cols = np.nonzero(A)
    vals = A[rows, cols].copy()
    if kind == "empty":
        vals[::7] = 0.0                   # explicit zeros: masked edges
    return RCSR.from_coo(rows, cols, vals, *A.shape, sum_duplicates=False)


def _port_csr(c):
    return TCSR(c.indptr.copy(), c.indices.copy(), c.data.copy(), c.n_rows,
                c.n_cols)


def _pair(csr, cfg):
    args = (csr.indptr, csr.indices, csr.data, csr.n_rows, csr.n_cols)
    return rp.build_pcsr(*args, _rcfg(cfg)), tp.build_pcsr(*args, cfg)


def _draw(rng, shape, integer):
    if integer:
        return rng.integers(-3, 4, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ transposes
@pytest.mark.parametrize("kind", ["skewed", "empty", "rect"])
def test_transposes_equal_reference(kind):
    csr = _graph(kind)
    args = (csr.indptr, csr.indices, csr.data, csr.n_rows, csr.n_cols)
    for a, b in zip(rp.transpose_csr(*args), tp.transpose_csr(*args)):
        assert np.array_equal(a, b)
    t = _port_csr(csr).transpose()
    r = csr.transpose()
    for f in ("indptr", "indices", "data", "n_rows", "n_cols"):
        assert np.array_equal(getattr(r, f), getattr(t, f)), f
    for cfg in rp.config_space(64):
        r, p = _pair(csr, _tcfg(cfg))
        r_t, p_t = rp.transpose_pcsr(r), tp.transpose_pcsr(p)
        for f in FIELDS:
            assert np.array_equal(getattr(r_t, f), getattr(p_t, f)), f
        assert (r_t.n_rows, r_t.n_cols, r_t.K, r_t.nnz) == \
            (p_t.n_rows, p_t.n_cols, p_t.K, p_t.nnz)
        for a, b in zip(rp.slot_transfer_map(r, r_t),
                        tp.slot_transfer_map(p, p_t)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(rp.pcsr_to_coo(r), tp.pcsr_to_coo(p)):
            assert np.array_equal(a, b)


def test_slot_transfer_map_rejects_other_edge_sets():
    csr = _graph("skewed")
    _, p = _pair(csr, tp.SpMMConfig(V=2, S=True, W=4))
    other = tp.build_pcsr(*tp.transpose_csr(csr.indptr, csr.indices[::-1],
                                            csr.data, csr.n_rows,
                                            csr.n_cols)[:3],
                          csr.n_cols, csr.n_rows, p.config)
    with pytest.raises(ValueError, match="same edge set"):
        tp.slot_transfer_map(p, other)


# --------------------------------------------------------------- raw SDDMM
@pytest.mark.parametrize("cfg", SMALL, ids=lambda c: str(c.astuple()))
def test_sddmm_matches_pallas_interpret(cfg):
    csr = _graph("empty")
    r, t = _pair(csr, cfg)
    rng = np.random.default_rng(3)
    C = t.num_chunks
    stored = t.steering(covered=True)["vals"]
    for integer in (True, False):
        Q = _draw(rng, (csr.n_rows, 16), integer)
        K = _draw(rng, (csr.n_cols, 16), integer)
        launches = sops.launch_count("sddmm")
        got = sops.sddmm(t, torch.from_numpy(Q), torch.from_numpy(K)).numpy()
        assert sops.launch_count("sddmm") == launches
        assert got.shape == (t.covered_num_chunks, cfg.V, t.K)
        want = np.asarray(rsops.sddmm(r, Q, K, interpret=True))
        slots = r_slots_ref(r, Q, K)
        if integer:
            assert np.array_equal(got[:C], want)
            assert np.array_equal(got[:C], slots)
        else:
            np.testing.assert_allclose(got[:C], want, rtol=0, atol=ATOL)
            np.testing.assert_allclose(got[:C], slots, rtol=0, atol=ATOL)
        assert (got[stored == 0] == 0).all(), "masked slots are exactly 0"


def test_sddmm_multihead_and_oracles():
    cfg = tp.SpMMConfig(V=2, S=True, W=8, B=True)
    csr = _graph("skewed")
    r, t = _pair(csr, cfg)
    rng = np.random.default_rng(4)
    Q = _draw(rng, (4, csr.n_rows, 8), True)
    K = _draw(rng, (4, csr.n_cols, 8), True)
    got = sops.sddmm(t, torch.from_numpy(Q), torch.from_numpy(K)).numpy()
    want = np.asarray(rsops.sddmm(r, Q, K, interpret=True))
    assert got.shape[0] == 4
    assert np.array_equal(got[:, :t.num_chunks], want)
    dense = csr.to_dense()
    rows, cols, flat = tp.pcsr_slot_coords(t)
    for h in (0, 3):
        one = sops.sddmm(t, torch.from_numpy(Q[h]),
                         torch.from_numpy(K[h])).numpy()
        assert np.array_equal(one, got[h])
        assert np.array_equal(
            one[:t.num_chunks],
            sddmm_slots_ref(t, torch.from_numpy(Q[h]),
                            torch.from_numpy(K[h])).numpy())
        E = sddmm_dense_ref(dense, torch.from_numpy(Q[h]),
                            torch.from_numpy(K[h])).numpy()
        assert np.array_equal(one.reshape(-1)[flat], E[rows, cols])
    with pytest.raises(ValueError, match="cpu or cuda"):
        sops.sddmm(t, torch.ones((csr.n_rows, 4), device="meta"),
                   torch.ones((csr.n_cols, 4), device="meta"))


# ------------------------------------------------------- SpMM operators
def _ops_pair(csr, cfg):
    r, t = _pair(csr, cfg)
    return (r, rp.transpose_pcsr(r)), (t, tp.transpose_pcsr(t))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("cfg", [tp.SpMMConfig(V=1, S=False, W=8),
                                 tp.SpMMConfig(V=2, S=True, W=4),
                                 tp.SpMMConfig(V=2, S=True, W=8, B=True)],
                         ids=lambda c: str(c.astuple()))
@pytest.mark.parametrize("kind", ["empty", "rect"])
def test_spmm_fn_grad_matches_reference(kind, cfg, integer):
    csr = _graph(kind, integer=integer)
    (r, r_t), (t, t_t) = _ops_pair(csr, cfg)
    rng = np.random.default_rng(5)
    B = _draw(rng, (csr.n_cols, 24), integer)
    dC = _draw(rng, (csr.n_rows, 24), integer)
    out, vjp = jax.vjp(rengine.make_spmm_fn(r, r_t), jnp.asarray(B))
    (want,) = vjp(jnp.asarray(dC))
    Bt = torch.from_numpy(B).requires_grad_()
    got_out = tengine.make_spmm_fn(t, t_t)(Bt)
    (got,) = torch.autograd.grad(got_out, Bt, torch.from_numpy(dC))
    check = (np.testing.assert_array_equal if integer else
             lambda a, b: np.testing.assert_allclose(a, b, rtol=0,
                                                     atol=ATOL))
    check(got_out.detach().numpy(), np.asarray(out))
    check(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("activation", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("cfg", [tp.SpMMConfig(V=1, S=True, W=16),
                                 tp.SpMMConfig(V=2, S=False, W=4)],
                         ids=lambda c: str(c.astuple()))
def test_fused_spmm_fn_grads_match_reference(cfg, activation, integer):
    csr = _graph("empty", integer=integer)
    (r, r_t), (t, t_t) = _ops_pair(csr, cfg)
    rng = np.random.default_rng(6)
    n, d = csr.n_rows, 16
    B, dOut = _draw(rng, (n, d), integer), _draw(rng, (n, d), integer)
    # multiples of 5 keep leaky_relu's 0.2·dOut integer-valued, so the
    # gradient sums stay exact in any order
    dOut = dOut * 5 if integer else dOut
    scale, bias = _draw(rng, (n,), integer), _draw(rng, (d,), integer)
    resid = _draw(rng, (n, d), integer)
    r_fused = rengine.make_fused_spmm_fn(r, r_t)
    t_fused = tengine.make_fused_spmm_fn(t, t_t)
    check = (np.testing.assert_array_equal if integer else
             lambda a, b: np.testing.assert_allclose(a, b, rtol=0,
                                                     atol=ATOL))
    for use_scale in (False, True):
        s_j = jnp.asarray(scale) if use_scale else None
        s_t = torch.from_numpy(scale) if use_scale else None
        f = lambda B_, b_, res_: r_fused(B_, scale=s_j, bias=b_,
                                         activation=activation,
                                         residual=res_)
        out, vjp = jax.vjp(f, *map(jnp.asarray, (B, bias, resid)))
        want = vjp(jnp.asarray(dOut))
        args = [torch.from_numpy(a).requires_grad_()
                for a in (B, bias, resid)]
        got_out = t_fused(args[0], scale=s_t, bias=args[1],
                          activation=activation, residual=args[2])
        got = torch.autograd.grad(got_out, args, torch.from_numpy(dOut))
        check(got_out.detach().numpy(), np.asarray(out))
        for g, w in zip(got, want):
            check(g.numpy(), np.asarray(w))


def test_gin_eps_grad_matches_reference():
    """GIN's ε enters through the fused residual ``(1+ε)h``: its gradient
    flows through autograd, as through the reference's ``custom_vjp``."""
    csr = _graph("skewed", integer=True)
    (r, r_t), (t, t_t) = _ops_pair(csr, tp.SpMMConfig(V=2, S=True, W=8))
    rng = np.random.default_rng(7)
    h = _draw(rng, (csr.n_rows, 8), True)
    w = _draw(rng, (8,), True)
    r_fused = rengine.make_fused_spmm_fn(r, r_t)

    def r_loss(eps, h_):
        return (r_fused(h_, residual=(1.0 + eps) * h_,
                        activation="relu") @ w).sum()

    want = jax.grad(r_loss, argnums=(0, 1))(jnp.float32(0.5),
                                            jnp.asarray(h))
    eps = torch.tensor(0.5, requires_grad=True)
    ht = torch.from_numpy(h).requires_grad_()
    out = tengine.make_fused_spmm_fn(t, t_t)(ht, residual=(1.0 + eps) * ht,
                                             activation="relu")
    got = torch.autograd.grad((out @ torch.from_numpy(w)).sum(), [eps, ht])
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


def test_backward_skips_unneeded_launches_and_needs_transpose():
    csr = _graph("skewed")
    (_, _), (t, t_t) = _ops_pair(csr, tp.SpMMConfig(V=1, S=True, W=8))
    B = torch.ones((csr.n_cols, 4), requires_grad=True)
    bias = torch.zeros(4, requires_grad=True)
    out = tengine.make_fused_spmm_fn(t, None)(B.detach(), bias=bias,
                                              activation="relu")
    (g,) = torch.autograd.grad(out.sum(), bias)     # dB not needed: no SpMM
    assert g.shape == (4,)
    with pytest.raises(ValueError, match="transpose PCSR"):
        torch.autograd.grad(tengine.make_spmm_fn(t)(B).sum(), B)
    op = tengine.ParamSpMMOperator(_port_csr(csr), t.config, device="cpu")
    (g,) = torch.autograd.grad(op(B).sum(), B)
    want = torch.from_numpy(csr.to_dense()).sum(0)[:, None].expand(-1, 4)
    torch.testing.assert_close(g, want, rtol=0, atol=1e-5)
    assert op.fused(B, bias=bias).shape == (csr.n_rows, 4)


# ------------------------------------------------------------ GAT message
def _gat_graph(n=48):
    """Rows without edges, explicit zeros, and one row whose Q is zero
    (so all its logits are 0)."""
    rng = np.random.default_rng(8)
    _, A = random_csr(rng, n, density=0.12, skew=True)
    A[6:14] = 0.0
    rows, cols = np.nonzero(A)
    vals = A[rows, cols].copy()
    vals[::9] = 0.0
    csr = RCSR.from_coo(rows, cols, vals, n, n, sum_duplicates=False)
    edge_rows = np.unique(rows[vals != 0])
    return csr, int(edge_rows[len(edge_rows) // 2])


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("cfg", [tp.SpMMConfig(V=2, S=True, W=4),
                                 tp.SpMMConfig(V=1, S=False, W=16)],
                         ids=lambda c: str(c.astuple()))
def test_gat_message_grads_match_reference(cfg, heads):
    csr, zero_row = _gat_graph()
    (r, r_t), (t, t_t) = _ops_pair(csr, cfg)
    rng = np.random.default_rng(9)
    lead = (heads,) if heads > 1 else ()
    n = csr.n_rows
    Q, K, Vf = (_draw(rng, lead + (n, 8), False) for _ in range(3))
    Q[..., zero_row, :] = 0.0
    dOut = _draw(rng, lead + (n, 8), False)
    Qj, Kj, Vj = map(jnp.asarray, (Q, K, Vf))
    wants = []
    for backend in ("pallas", "engine"):
        f = rengine.make_gat_message_fn(r, r_t, backend=backend,
                                        interpret=True)
        out, vjp = jax.vjp(f, Qj, Kj, Vj)
        wants.append((np.asarray(out),
                      [np.asarray(g) for g in vjp(jnp.asarray(dOut))]))
    args = [torch.from_numpy(a).requires_grad_() for a in (Q, K, Vf)]
    launches = (pops.launch_count(), sops.launch_count("sddmm_softmax"),
                sops.launch_count("sddmm"))
    out = tengine.make_gat_message_fn(t, t_t)(*args)
    got = torch.autograd.grad(out, args, torch.from_numpy(dOut))
    assert launches == (pops.launch_count(),
                        sops.launch_count("sddmm_softmax"),
                        sops.launch_count("sddmm"))
    for w_out, w_grads in wants:
        np.testing.assert_allclose(out.detach().numpy(), w_out, rtol=0,
                                   atol=ATOL)
        for g, w in zip(got, w_grads):
            assert bool(torch.isfinite(g).all())
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
    # rows without an edge aggregate nothing and pass no gradient to Q
    assert (got[0][..., 6:14, :] == 0).all()


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_row_dot_equals_the_index_add_row_sum(heads):
    csr, _ = _gat_graph()
    cfg = tp.SpMMConfig(V=2, S=True, W=4)
    _, t = _pair(csr, cfg)
    steer = pops.device_steering(t, "cpu")
    geo = dict(n_blocks=t.n_blocks, R=cfg.R, V=cfg.V, K=t.K, n_rows=t.n_rows)
    rng = np.random.default_rng(12)
    lead = (heads,) if heads > 1 else ()
    Q, K, Vf, dOut = (torch.from_numpy(_draw(rng, lead + (csr.n_rows, 8),
                                             False)) for _ in range(4))
    logits, rowmax, rowsum = sops._stats_call(steer, Q, K, scale=8 ** -0.5,
                                              **geo)
    out = pops._call(steer, Vf, vals=logits, rowmax=rowmax, rowsum=rowsum,
                     dblk=cfg.dblk, **geo)
    alpha = tengine.normalize_from_stats(logits, rowmax, rowsum, steer.lrow,
                                         steer.trow, R=cfg.R, V=cfg.V, K=t.K)
    dalpha = sops._call(steer, dOut, Vf, **geo)
    rows = tengine._slot_rows(steer.lrow, steer.trow, V=cfg.V, R=cfg.R,
                              K=t.K)
    n_seg = t.n_blocks * cfg.R
    # the form the backward took before: index_add_ over each row's slots
    flat = (alpha * dalpha).reshape(-1, rows.numel())
    seg = (torch.arange(flat.shape[0])[:, None] * n_seg
           + rows.reshape(1, -1))
    old = flat.new_zeros(flat.shape[0] * n_seg).index_add_(
        0, seg.reshape(-1), flat.reshape(-1))[seg].reshape(alpha.shape)
    # _row_dot gives each row's sum; the slot pass gathers it per slot
    new = tengine._row_dot(dOut, out, n_seg)[..., rows]
    assert new.shape == alpha.shape
    assert torch.equal(new, tengine._row_dot(dOut, out, n_seg)[..., rows])
    np.testing.assert_allclose(new.numpy(), old.numpy(), rtol=0, atol=ATOL)


def test_gat_message_builds_transpose_and_skips_unneeded_grads():
    csr, _ = _gat_graph(40)
    _, t = _pair(csr, tp.SpMMConfig(V=1, S=True, W=8))
    rng = np.random.default_rng(10)
    Q, K, Vf = (torch.from_numpy(_draw(rng, (40, 4), False))
                for _ in range(3))
    Vf.requires_grad_()
    f = tengine.make_gat_message_fn(t)              # transpose packed lazily
    (g,) = torch.autograd.grad(f(Q, K, Vf).sum(), Vf)
    t_t = tp.transpose_pcsr(t)
    (want,) = torch.autograd.grad(
        tengine.make_gat_message_fn(t, t_t)(Q, K, Vf).sum(), Vf)
    assert torch.equal(g, want)
    steer = pops.device_steering(t, "cpu")
    msg = tengine.gat_message_fn(steer, t)          # no transpose: serving
    with pytest.raises(ValueError, match="transpose PCSR"):
        torch.autograd.grad(msg(Q, K, Vf).sum(), Vf)
