"""The GAT backward's slot pass (``kernels.sddmm.ops.gat_backward``) on
CPU tensors, where it runs its plain version.

* The plain version equals the composition the backward ran before it
  (``normalize_from_stats``, the softmax vjp over ``_row_dot``'s gathered
  row sums, ``de``, then two transfers onto Aᵀ by ``slot_transfer_map``'s
  ``f_idx``/``t_idx``: zero-fill, gather, scatter) bit for bit, at no head
  axis, 1 and 8 heads, V = 1 and 2, every subset of the three outputs, on
  a skewed and an even graph.
* Aᵀ slots that hold no edge read exactly +0.
* ``TransposeSide.src`` agrees with ``slot_transfer_map`` and carries A's
  values onto Aᵀ's.
* The GAT message's gradients match PyTorch autograd through a dense
  masked softmax, and each backward makes one slot pass with the needs of
  its inputs.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.pcsr import (SpMMConfig, build_pcsr, slot_transfer_map,
                                   transpose_pcsr)
from repro_torch.core.sparse import CSRMatrix
from repro_torch.kernels.paramspmm import ops as pops
from repro_torch.kernels.sddmm import ops as sops

N = 56
NEEDS = [n for n in itertools.product((False, True), repeat=3) if any(n)]
SLOPE = 0.2


def _dense(kind: str):
    """A ``kind`` ("skewed": hub rows and empty rows; "even": 4 edges a
    row) graph as ``(pattern, values)``: integer values, and every 11th
    stored entry an explicit zero (a masked slot)."""
    rng = np.random.default_rng(3 if kind == "skewed" else 4)
    if kind == "skewed":
        pattern = rng.random((N, N)) < 0.08
        pattern[rng.integers(0, N, 3)] = rng.random((3, N)) < 0.6
        pattern[10:17] = False
    else:
        pattern = np.zeros((N, N), bool)
        for i in range(N):
            pattern[i, rng.choice(N, 4, replace=False)] = True
    values = rng.integers(1, 4, (N, N)).astype(np.float32) * pattern
    r, c = np.nonzero(pattern)
    values[r[::11], c[::11]] = 0.0
    return pattern, values


@functools.lru_cache(maxsize=None)
def _pack(kind: str, V: int):
    """``(A, pcsr, pcsr_t)``: A dense (0 off the pattern and at the
    explicit zeros) and its PCSR pair at V."""
    pattern, A = _dense(kind)
    r, c = np.nonzero(pattern)
    csr = CSRMatrix.from_coo(r, c, A[r, c], N, N, sum_duplicates=False)
    p = build_pcsr(csr.indptr, csr.indices, csr.data, N, N,
                   SpMMConfig(V=V, S=True, W=8 // V))
    return A, p, transpose_pcsr(p)


def _operands(kind, V, heads, seed=0):
    """Forward residuals and backward operands of one GAT message."""
    A, p, p_t = _pack(kind, V)
    steer = pops.device_steering(p, "cpu")
    t = engine.TransposeSide.build(p, p_t, "cpu")
    g = torch.Generator().manual_seed(seed)
    lead = () if heads is None else (heads,)
    Q, K, Vf, dOut = (torch.randn(lead + (N, 8), generator=g)
                      for _ in range(4))
    geo = dict(n_blocks=p.n_blocks, R=p.config.R, V=V, K=p.K, n_rows=N)
    logits, rm, rs = sops._stats_call(steer, Q, K, scale=8 ** -0.5,
                                      slope=SLOPE, **geo)
    out = pops._call(steer, Vf, vals=logits, rowmax=rm, rowsum=rs,
                     dblk=p.config.dblk, **geo)
    dalpha = sops._call(steer, dOut, Vf, **geo)
    rowdot = engine._row_dot(dOut, out, p.n_blocks * p.config.R)
    return p, p_t, steer, t, logits, rm, rs, dalpha, rowdot


def _earlier_composition(p, p_t, steer, logits, rm, rs, dalpha, rowdot,
                         scale):
    """The backward's slot work as it ran before the slot pass: α, the
    vjp, ``de``, and ``TransposeSide.to_transpose``'s zero-fill, int64
    gather and int64 scatter."""
    R, V, K = p.config.R, p.config.V, p.K
    alpha = engine.normalize_from_stats(logits, rm, rs, steer.lrow,
                                        steer.trow, R=R, V=V, K=K)
    rows = engine._slot_rows(steer.lrow, steer.trow, V=V, R=R, K=K)
    dx = alpha * (dalpha - rowdot[..., rows])
    de = dx * scale * torch.where(logits >= 0, 1.0, SLOPE)
    f_idx, t_idx = (torch.as_tensor(a, dtype=torch.int64)
                    for a in slot_transfer_map(p, p_t))
    shape = (p_t.covered_num_chunks, p_t.config.V, p_t.K)

    def to_transpose(x):
        lead = x.shape[:-3]
        out = x.new_zeros(lead + (int(np.prod(shape)),))
        out[..., t_idx] = x.reshape(lead + (-1,))[..., f_idx]
        return out.reshape(lead + shape)
    return de, to_transpose(de), to_transpose(alpha)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("needs", NEEDS, ids=lambda n: "qkv-" + "".join(
    "1" if x else "0" for x in n))
@pytest.mark.parametrize("heads", [None, 1, 8], ids=lambda h: f"H{h}")
@pytest.mark.parametrize("V", [1, 2])
@pytest.mark.parametrize("kind", ["skewed", "even"])
def test_plain_slot_pass_equals_the_earlier_composition(kind, V, heads,
                                                        needs):
    p, p_t, steer, t, logits, rm, rs, dalpha, rowdot = _operands(kind, V,
                                                                 heads)
    need_q, need_k, need_v = needs
    scale = 8 ** -0.5
    want = _earlier_composition(p, p_t, steer, logits, rm, rs, dalpha,
                                rowdot, scale)
    need_dx = need_q or need_k
    launches = sops.launch_count("gat_backward")
    got = sops.gat_backward(
        steer, t.src, logits, rm, rs, R=p.config.R, V=V, K=p.K,
        t_shape=t.shape, scale=scale, slope=SLOPE,
        dalpha=dalpha if need_dx else None,
        rowdot=rowdot if need_dx else None, need_q=need_q, need_k=need_k,
        need_v=need_v)
    assert sops.launch_count("gat_backward") == launches  # CPU: no launch
    for need, g, w in zip(needs, got, want):
        if not need:
            assert g is None
            continue
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("heads", [None, 8], ids=lambda h: f"H{h}")
@pytest.mark.parametrize("kind", ["skewed", "even"])
def test_transpose_slots_without_an_edge_read_exact_zero(kind, heads):
    p, _, steer, t, logits, rm, rs, dalpha, rowdot = _operands(kind, 1,
                                                               heads, seed=1)
    empty = t.src < 0
    assert bool(empty.any()) and bool((~empty).any())
    _, de_t, alpha_t = sops.gat_backward(
        steer, t.src, logits, rm, rs, R=p.config.R, V=1, K=p.K,
        t_shape=t.shape, scale=0.5, slope=SLOPE, dalpha=dalpha,
        rowdot=rowdot)
    for x in (de_t, alpha_t):
        flat = x.reshape(x.shape[:-3] + (-1,))[..., empty]
        assert torch.equal(_bits(flat), torch.zeros_like(_bits(flat)))


@pytest.mark.parametrize("V", [1, 2])
@pytest.mark.parametrize("kind", ["skewed", "even"])
def test_src_map_agrees_with_slot_transfer_map(kind, V):
    A, p, p_t = _pack(kind, V)
    t = engine.TransposeSide.build(p, p_t, "cpu")
    f_idx, t_idx = slot_transfer_map(p, p_t)
    assert t.src.dtype == torch.int32
    assert t.src.shape == (int(np.prod(t.shape)),)
    assert t.shape == (p_t.covered_num_chunks, p_t.config.V, p_t.K)
    src = t.src.numpy()
    # round trip: every edge's Aᵀ slot maps back to its A slot, and only
    # those slots map anywhere
    assert np.array_equal(src[t_idx], f_idx)
    mapped = src[src >= 0]
    assert len(mapped) == len(f_idx) == len(np.unique(mapped))
    assert (src[np.setdiff1d(np.arange(src.size), t_idx)] == -1).all()
    # A's stored values land on the slots of Aᵀ that hold the same edges
    steer = pops.device_steering(p, "cpu")
    steer_t = pops.device_steering(p_t, "cpu")
    moved = sops.slot_transfer(steer.vals, t.src, t.shape)
    assert torch.equal(moved, steer_t.vals)


def _dense_gat(A, Q, K, Vf):
    """The GAT message in dense PyTorch: softmax over each row's stored
    nonzeros of LeakyReLU(Q·Kᵀ/√d), then α·Vf; a row without one is 0."""
    mask = torch.as_tensor(A != 0)
    x = Q @ K.transpose(-1, -2) / np.sqrt(Q.shape[-1])
    x = torch.where(x >= 0, x, SLOPE * x).masked_fill(~mask, -torch.inf)
    alpha = torch.softmax(x, dim=-1).nan_to_num(0.0)
    return alpha @ Vf


@pytest.mark.parametrize("heads", [None, 8], ids=lambda h: f"H{h}")
@pytest.mark.parametrize("V", [1, 2])
@pytest.mark.parametrize("kind", ["skewed", "even"])
def test_gat_message_grads_match_dense_autograd(kind, V, heads):
    A, p, p_t = _pack(kind, V)
    g = torch.Generator().manual_seed(7)
    lead = () if heads is None else (heads,)
    args = [torch.randn(lead + (N, 8), generator=g).requires_grad_()
            for _ in range(3)]
    dOut = torch.randn(lead + (N, 8), generator=g)
    out = engine.make_gat_message_fn(p, p_t, slope=SLOPE)(*args)
    got = torch.autograd.grad(out, args, dOut)
    ref = _dense_gat(A, *args)
    want = torch.autograd.grad(ref, args, dOut)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("needs", NEEDS, ids=lambda n: "qkv-" + "".join(
    "1" if x else "0" for x in n))
def test_gat_backward_makes_one_slot_pass_with_its_inputs_needs(
        monkeypatch, needs):
    _, p, p_t = _pack("skewed", 1)
    calls = []
    real = sops.gat_backward

    def spy(*a, **kw):
        calls.append((kw["need_q"], kw["need_k"], kw["need_v"],
                      kw["dalpha"] is not None))
        return real(*a, **kw)
    monkeypatch.setattr(sops, "gat_backward", spy)
    g = torch.Generator().manual_seed(9)
    args = [torch.randn((4, N, 8), generator=g).requires_grad_(need)
            for need in needs]
    out = engine.make_gat_message_fn(p, p_t)(*args)
    grads = torch.autograd.grad(out.sum(), [a for a in args
                                            if a.requires_grad])
    assert calls == [needs + ((needs[0] or needs[1]),)]
    assert all(bool(torch.isfinite(x).all()) for x in grads)


def test_gat_backward_refuses_missing_operands_and_other_devices():
    p, _, steer, t, logits, rm, rs, dalpha, rowdot = _operands("even", 1, 4)
    kw = dict(R=p.config.R, V=1, K=p.K, t_shape=t.shape, scale=0.5)
    with pytest.raises(ValueError, match="dalpha and rowdot"):
        sops.gat_backward(steer, t.src, logits, rm, rs, **kw)
    with pytest.raises(ValueError, match="dalpha and rowdot"):
        sops.gat_backward(steer, t.src, logits, rm, rs, dalpha=dalpha,
                          need_q=False, **kw)
    # α alone needs neither
    _, _, alpha_t = sops.gat_backward(steer, t.src, logits, rm, rs,
                                      need_q=False, need_k=False, **kw)
    assert alpha_t.shape == (4,) + t.shape
    meta = logits.to("meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        sops.gat_backward(steer, t.src, meta, rm, rs, need_q=False,
                          need_k=False, **kw)


def test_launch_counter_has_the_slot_pass():
    assert "gat_backward" in sops.KERNELS
    sops.count_launches("gat_backward", 3)
    assert sops.launch_count("gat_backward") >= 3
    sops.reset_launch_count()
    assert sops.launch_count("gat_backward") == 0
