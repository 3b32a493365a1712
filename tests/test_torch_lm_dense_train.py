"""PyTorch port vs JAX reference: training the decoder-only families
(dense qwen2 / qwen1.5 / chatglm3 / gemma2, VLM llava-next, MoE granite)
at their reduced configs, B = 2, S = 32, attention chunk 16.

``train_loss`` and its gradients against ``jax.value_and_grad`` of the
reference's on the same parameters (its ``init_params``, carried across
bit for bit): the loss within ``rtol=1e-3`` and every gradient leaf
within 5e-2 relative L2 error (``tests/test_torch_lm_train.py``'s rule).
Remat on and off: the same bits.  The input and cache specs equal the
reference's at every shape cell.  The launcher's donating step (AdamW in
place) gives the bits of the functional one.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import lm as rlm

from repro_torch.configs import get_reduced
from repro_torch.configs.base import SHAPES
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw as tadamw
from repro_torch.models import lm as tlm
from repro_torch.optim.adamw import tree_leaves, tree_map

from test_torch_lm_dense import ARCHS, CHUNK, ref_case

GRAD_REL_L2 = 5e-2


def _grads(params, cfg, batch, **kw):
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = tlm.train_loss(p, cfg, batch, **kw)
    loss.backward()
    return loss.detach(), tree_map(lambda t: t.grad, p)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    case = ref_case(request.param)
    loss, grads = jax.value_and_grad(lambda p: rlm.train_loss(
        p, case.cfg, case.batch, chunk=CHUNK))(case.params)
    case.loss, case.grads = float(loss), jax.tree.map(np.asarray, grads)
    return case


def test_train_loss_and_grads_match_reference(ref):
    loss, grads = _grads(ref.tparams, ref.tcfg, ref.tbatch, chunk=CHUNK)
    np.testing.assert_allclose(float(loss), ref.loss, rtol=1e-3)
    worst = 0.0
    for path, want in jax.tree_util.tree_flatten_with_path(ref.grads)[0]:
        got = grads
        for k in path:
            got = got[k.key]
        assert got.dtype == torch.bfloat16, path
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= GRAD_REL_L2, (path, err)
        worst = max(worst, err)
    assert worst > 0          # the two frameworks round apart somewhere


def test_remat_does_not_change_loss_or_grads(ref):
    l1, g1 = _grads(ref.tparams, ref.tcfg, ref.tbatch, chunk=CHUNK,
                    remat=True)
    l0, g0 = _grads(ref.tparams, ref.tcfg, ref.tbatch, chunk=CHUNK,
                    remat=False)
    assert torch.equal(l1, l0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)


def test_input_and_cache_specs_match_reference(ref):
    for name, cell in SHAPES.items():
        want = rlm.input_specs(ref.cfg, cell)
        got = tlm.input_specs(ref.tcfg, cell)
        assert {k: (tuple(v.shape), v.dtype.name) for k, v in want.items()} \
            == {k: (v[0], str(v[1]).split(".")[-1])
                for k, v in got.items()}, name
        want = rlm.cache_specs(ref.cfg, cell)
        got = tlm.cache_specs(ref.tcfg, cell)
        assert {k: (tuple(v.shape), v.dtype.name) for k, v in want.items()} \
            == {k: (v[0], str(v[1]).split(".")[-1])
                for k, v in got.items()}, name


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "hymba-1.5b"])
@pytest.mark.parametrize("compress", [0.0, 0.05])
def test_donated_step_gives_the_functional_bits(arch, compress):
    """Three steps of ``build_step(donate=True)`` (parameters, moments and
    gradients updated in place, stacked leaves a layer at a time) against
    the functional step on copies: the same losses, parameters and state
    bit for bit; the donated inputs are the outputs."""
    cfg = get_reduced(arch)
    opt = tadamw.AdamWConfig(lr=3e-3, grad_clip=1.0)
    params = tlm.init_params(cfg, generator=torch.Generator().manual_seed(2),
                             device="cpu")
    runs = {}
    for donate in (False, True):
        step = ttrain.build_step(cfg, opt, compress, donate=donate)
        p = _clone(params)
        s = tadamw.adamw_init(p)
        e = (ttrain.topk_compress_init(p) if compress
             else torch.zeros((), dtype=torch.float32))
        losses = []
        for i in range(3):
            p_in, m_in = p, s["m"]
            p, s, e, loss = step(p, s, e, ttrain.device_batch(
                cfg, 2, 16, i, 0, "cpu"))
            losses.append(loss)
            if donate:
                assert all(a is b for a, b in zip(tree_leaves(p),
                                                  tree_leaves(p_in)))
                assert all(a is b for a, b in zip(tree_leaves(s["m"]),
                                                  tree_leaves(m_in)))
        runs[donate] = (losses, p, s)
    (l0, p0, s0), (l1, p1, s1) = runs[False], runs[True]
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert s0["step"] == s1["step"] == 3
    for a, b in zip(tree_leaves((p0, s0["m"], s0["v"])),
                    tree_leaves((p1, s1["m"], s1["v"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("piece", [1, 5, 7, 1 << 24])
def test_inplace_adamw_in_pieces_gives_the_functional_bits(piece,
                                                           monkeypatch):
    """AdamW in place, each leaf's flat view cut into pieces of at most
    ``piece`` elements (one each; a row; pieces across rows; whole
    leaves; a 0-d leaf), clipped and with weight decay: the functional
    update's bits."""
    monkeypatch.setattr(tadamw, "INPLACE_PIECE", piece)
    g = torch.Generator().manual_seed(0)
    draw = lambda *s: torch.randn(s, generator=g)
    tree = lambda: {"a": draw(5, 4).to(torch.bfloat16),
                    "b": {"c": draw(3, 2, 6).to(torch.bfloat16)},
                    "e": draw()}
    params, grads = tree(), tree()
    cfg = tadamw.AdamWConfig(lr=1e-2, grad_clip=0.5, weight_decay=0.1)
    state = tadamw.adamw_init(params)
    p0, s0 = tadamw.adamw_update(params, _clone(grads), _clone_state(state),
                                 cfg)
    p1, s1 = tadamw.adamw_update(_clone(params), _clone(grads),
                                 _clone_state(state), cfg, inplace=True)
    for a, b in zip(tree_leaves((p0, s0["m"], s0["v"])),
                    tree_leaves((p1, s1["m"], s1["v"]))):
        assert torch.equal(a, b)


def _clone_state(state):
    return {"m": _clone(state["m"]), "v": _clone(state["v"]),
            "step": state["step"]}
