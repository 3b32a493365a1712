"""PyTorch port vs JAX reference: RWKV6 (``rwkv6-1.6b``) as a whole model
through ``models/lm.py``, at its reduced config (2 layers, d_model 128, two
heads of 64, vocab 256), B = 2, S = 32.

Both packages run the same parameters: the reference's ``init_params``
with each layer redrawn at live scales (``test_torch_rwkv.live_layer``:
at the N(0, 0.02) init the WKV term adds almost nothing), carried across
bit for bit by ``lm_params_to_torch``.  Held: the hidden states and the
prefill logits within the reference's bf16 tolerance ``atol = rtol =
5e-2``; ``train_loss`` within ``rtol=1e-3`` and every gradient leaf
within 5e-2 relative L2 (``tests/test_torch_lm_dense_train.py``'s rules);
teacher-forced ``decode_step`` logits and the final caches within 5e-2 of
the reference's, and one step from a non-zero cache; the port's decode
against its own forward at the reference's ``atol=0.15, rtol=0.05``
(``tests/test_models_lm.py::test_decode_matches_forward``); greedy
``generate`` equal to the reference's up to each row's first near-tie;
the launchers on the CPU; the specs and the model-FLOP arithmetic at
every shape cell.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.data import tokens as rtokens
from repro.launch import roofline as rroof
from repro.launch import serve as rserve
from repro.models import lm as rlm

from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_params_to_torch
from repro_torch.launch import roofline as troof
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttf
from repro_torch.optim.adamw import tree_leaves, tree_map

from test_torch_rwkv import live_layer

ARCH = "rwkv6-1.6b"
MODEL_TOL = dict(atol=5e-2, rtol=5e-2)
GRAD_REL_L2 = 5e-2
B, S = 2, 32
TIE = 1e-2


def _np(x):
    return np.asarray(x, np.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def case(arch, params, batch):
    """Both packages' config, parameters and batch of one model."""
    np_params = jax.tree.map(np.asarray, params)
    return SimpleNamespace(
        arch=arch, cfg=rconfigs.get_reduced(arch),
        tcfg=tconfigs.get_reduced(arch), params=params, np_params=np_params,
        tparams=lm_params_to_torch(np_params),
        batch={k: jnp.asarray(v) for k, v in batch.items()},
        tbatch={k: torch.from_numpy(v) for k, v in batch.items()})


def live_params(seed=0):
    cfg = rconfigs.get_reduced(ARCH)
    params = rlm.init_params(jax.random.PRNGKey(seed), cfg)
    layers = [live_layer(seed + i)[0] for i in range(cfg.n_layers)]
    params["layers"] = jax.tree.map(lambda *a: jnp.stack(a), *layers)
    return params


@pytest.fixture(scope="module")
def ref():
    cfg = rconfigs.get_reduced(ARCH)
    c = case(ARCH, live_params(), rtokens.batch_for_step(cfg, B, S, 3, 0))
    c.hidden = rlm.forward_hidden(c.params, cfg, c.batch, remat=False)
    c.logits = rlm.prefill(c.params, cfg, c.batch)
    loss, grads = jax.value_and_grad(
        lambda p: rlm.train_loss(p, cfg, c.batch))(c.params)
    c.loss, c.grads = float(loss), dict(_leaves(jax.tree.map(np.asarray,
                                                             grads)))
    c.step = jax.jit(lambda p, t, cc, pos: rlm.decode_step(p, cfg, t, cc,
                                                           pos))
    return c


# ---------------------------------------------------------- parameters
def test_model_defs_equal_reference():
    for get in ("get_config", "get_reduced"):
        want = dict(_leaves(rlm.model_defs(getattr(rconfigs, get)(ARCH))))
        got = dict(_leaves(tlm.model_defs(getattr(tconfigs, get)(ARCH))))
        assert {k: (tuple(v[0]), v[1]) for k, v in got.items()} == \
            {k: (tuple(v[0]), v[1]) for k, v in want.items()}


def test_lm_params_to_torch_carries_the_tree_bit_for_bit(ref):
    got, want = dict(_leaves(ref.tparams)), dict(_leaves(ref.np_params))
    assert list(got) == list(want)
    for name, a in want.items():
        t = got[name]
        assert tuple(t.shape) == a.shape and t.dtype == torch.bfloat16, name
        assert np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16)), name


def test_init_params_follows_reference_rules():
    cfg = rconfigs.get_reduced(ARCH)
    want = dict(_leaves(jax.tree.map(np.asarray, rlm.init_params(
        jax.random.PRNGKey(0), cfg))))
    got = dict(_leaves(tlm.init_params(
        tconfigs.get_reduced(ARCH), generator=torch.Generator().manual_seed(0),
        device="cpu")))
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16, name
        w = _np(w)
        if np.all(w == w.flat[0]):            # ones, zeros, 0.5, −1
            assert torch.equal(g.float(), torch.from_numpy(w)), name
        else:                                 # N(0, 0.02)
            assert abs(float(g.float().std()) - 0.02) < 0.003, name


# ------------------------------------------------------------- forward
def test_forward_hidden_matches_reference(ref):
    got = tlm.forward_hidden(ref.tparams, ref.tcfg, ref.tbatch)
    want = _np(ref.hidden)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape == (B, S, ref.cfg.d_model)
    np.testing.assert_allclose(got.float().numpy(), want, **MODEL_TOL)


def test_prefill_matches_reference(ref):
    got = tlm.prefill(ref.tparams, ref.tcfg, ref.tbatch)
    want = _np(ref.logits)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (B, 1, ref.cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


# ------------------------------------------------------------ training
def _grads(params, cfg, batch, **kw):
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = tlm.train_loss(p, cfg, batch, **kw)
    loss.backward()
    return loss.detach(), tree_map(lambda t: t.grad, p)


def hold_loss_and_grads(ref):
    loss, grads = _grads(ref.tparams, ref.tcfg, ref.tbatch)
    np.testing.assert_allclose(float(loss), ref.loss, rtol=1e-3)
    worst = 0.0
    for name, g in _leaves(grads):
        assert g.dtype == torch.bfloat16, name
        want = _np(ref.grads[name])
        err = np.linalg.norm(g.float().numpy() - want) / max(
            np.linalg.norm(want), 1e-30)
        assert err <= GRAD_REL_L2, (name, err)
        worst = max(worst, err)
    assert worst > 0          # the two frameworks round apart somewhere


def test_train_loss_and_grads_match_reference(ref):
    hold_loss_and_grads(ref)


def test_remat_does_not_change_loss_or_grads(ref):
    l1, g1 = _grads(ref.tparams, ref.tcfg, ref.tbatch, remat=True)
    l0, g0 = _grads(ref.tparams, ref.tcfg, ref.tbatch, remat=False)
    assert torch.equal(l1, l0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)


# -------------------------------------------------------------- decode
def _caches(ref, steps):
    rcache = rlm.init_cache(ref.cfg, rbase.ShapeCell("d", steps, B,
                                                     "decode"))
    tcache = tlm.init_cache(ref.tcfg, tbase.ShapeCell("d", steps, B,
                                                      "decode"),
                            device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tcache.items()} == \
        {k: (v.shape, v.dtype.name) for k, v in rcache.items()}
    return rcache, tcache


def test_decode_steps_and_caches_match_reference(ref):
    steps = 12
    rcache, tcache = _caches(ref, steps)
    tokens = np.random.default_rng(12).integers(0, ref.cfg.vocab,
                                                (B, steps))
    for t in range(steps):
        want, rcache = ref.step(ref.params, jnp.asarray(tokens[:, t:t + 1],
                                                        jnp.int32),
                                rcache, jnp.int32(t))
        got, tcache = tlm.decode_step(ref.tparams, ref.tcfg,
                                      torch.as_tensor(tokens[:, t:t + 1]),
                                      tcache, torch.tensor(t))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL,
                                   err_msg=f"step {t}")
    for name, want in rcache.items():
        np.testing.assert_allclose(tcache[name].float().numpy(), _np(want),
                                   **MODEL_TOL, err_msg=name)


def test_decode_step_from_a_nonzero_cache_matches_reference(ref):
    """One step from a seeded cache (bf16 shifts, float32 WKV states of
    unit scale): the logits and every new cache tensor; the port's cache
    is overwritten in place."""
    rcache, tcache = _caches(ref, 4)
    rng = np.random.default_rng(21)
    for name, want in list(rcache.items()):
        a = rng.standard_normal(want.shape)
        rcache[name] = jnp.asarray(a, want.dtype)
        tcache[name].copy_(torch.from_numpy(np.array(rcache[name],
                                                     np.float32)))
    before = {k: v for k, v in tcache.items()}
    tok = rng.integers(0, ref.cfg.vocab, (B, 1))
    want, rnew = ref.step(ref.params, jnp.asarray(tok, jnp.int32), rcache,
                          jnp.int32(3))
    got, tnew = tlm.decode_step(ref.tparams, ref.tcfg, torch.as_tensor(tok),
                                tcache, 3)
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)
    for name, w in rnew.items():
        assert tnew[name] is before[name], name
        np.testing.assert_allclose(tnew[name].float().numpy(), _np(w),
                                   **MODEL_TOL, err_msg=name)


def test_tensor_pos_equals_int_pos(ref):
    caches = [_caches(ref, 6)[1] for _ in "ab"]
    tokens = np.random.default_rng(13).integers(0, ref.cfg.vocab, (B, 6))
    for t in range(6):
        tok = torch.as_tensor(tokens[:, t:t + 1])
        a, _ = tlm.decode_step(ref.tparams, ref.tcfg, tok, caches[0],
                               torch.tensor(t))
        b, _ = tlm.decode_step(ref.tparams, ref.tcfg, tok, caches[1], t)
        assert torch.equal(a, b)


def test_decode_matches_forward(ref):
    """The port's teacher-forced decode against its own forward, every
    position (the reference test's tolerances)."""
    steps = 12
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        1, ref.cfg.vocab, (B, steps)))
    h = tlm.forward_hidden(ref.tparams, ref.tcfg, {"tokens": tokens},
                           remat=False)
    want = ttf.logits_for(h, ref.tparams, ref.tcfg)
    cache = _caches(ref, steps)[1]
    outs = []
    for t in range(steps):
        logits, cache = tlm.decode_step(ref.tparams, ref.tcfg,
                                        tokens[:, t:t + 1], cache, t)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), want, atol=0.15,
                               rtol=0.05)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_generate_matches_reference(ref, seed):
    """Greedy tokens equal the reference's ``generate`` up to each row's
    first near-tie (top-two reference logits within ``TIE``)."""
    hold_generate(ref, seed)


def hold_generate(ref, seed, P=6, total=14):
    prompt = np.random.default_rng(seed).integers(0, ref.cfg.vocab, (B, P))
    want = np.array(rserve.generate(ref.cfg, ref.params,
                                    jnp.asarray(prompt, jnp.int32),
                                    total, total - P))
    got = tserve.generate(ref.tcfg, ref.tparams, prompt, total, total - P,
                          device="cpu").numpy()
    assert got.shape == want.shape == (B, total)
    rcache = rlm.init_cache(ref.cfg, rbase.ShapeCell("d", total, B,
                                                     "decode"))
    agree = np.full(B, total)
    for t in range(total - 1):
        rl, rcache = ref.step(ref.params, jnp.asarray(want[:, t:t + 1]),
                              rcache, jnp.int32(t))
        if t + 1 < P:
            continue
        top2 = np.sort(_np(rl)[:, 0], axis=-1)[:, -2:]
        tie = top2[:, 1] - top2[:, 0] <= TIE
        agree = np.where(tie, np.minimum(agree, t + 1), agree)
    for b in range(B):
        np.testing.assert_array_equal(got[b, :agree[b]], want[b, :agree[b]])
    assert agree.max() > P


# ---------------------------------------------------------- launchers
def test_train_cli_runs(capsys):
    losses = ttrain.train(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "5", "--batch", "2", "--seq", "16",
                           "--log-every", "4"])
    assert len(losses) == 5 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "done: loss" in capsys.readouterr().out


def test_serve_cli_runs(capsys):
    seq = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--prompt-len", "4", "--gen", "6"])
    assert tuple(seq.shape) == (4, 10)
    assert int(seq.max()) < ttrain.get_reduced(ARCH).vocab
    assert "generated (4, 10) on cpu" in capsys.readouterr().out


# --------------------------------------------------------------- specs
@pytest.mark.parametrize("full", [False, True])
def test_specs_and_model_flops_match_reference(full):
    """``cache_specs``, ``input_specs``, ``param_count`` and
    ``model_flops_for`` at every shape cell."""
    hold_specs(ARCH, full)


def hold_specs(arch, full):
    get = "get_config" if full else "get_reduced"
    rcfg, tcfg = getattr(rconfigs, get)(arch), getattr(tconfigs, get)(arch)
    assert troof.param_count(tcfg) == rroof.param_count(rcfg)
    as_pairs = lambda specs: {k: (tuple(v.shape), v.dtype.name)
                              for k, v in specs.items()}
    for name, cell in tbase.SHAPES.items():
        rcell = rbase.SHAPES[name]
        for fn in ("cache_specs", "input_specs"):
            want = as_pairs(getattr(rlm, fn)(rcfg, rcell))
            got = {k: (v[0], str(v[1]).split(".")[-1])
                   for k, v in getattr(tlm, fn)(tcfg, cell).items()}
            assert got == want, (fn, name)
        assert troof.model_flops_for(tcfg, cell) == rroof.model_flops_for(
            rcfg, rcell), name
