"""PyTorch port vs JAX reference: LM training for the hybrid family.

The reduced Hymba (3 layers, d_model 64) runs in both packages on the same
weights: the reference's ``init_params`` with ``bc_w`` and ``d_skip``
redrawn from numpy (its init rule zeroes both), carried across bit for bit
by ``lm_params_to_torch``.  Inputs come from numpy seeds.

Tolerances.  The loss functions on operands whose products are exact in
bf16: ``rtol=1e-6`` (the sums run in another order).  ``train_loss`` and
its gradients at B = 2, S = 32 against ``jax.value_and_grad``: the loss
within ``rtol=1e-3`` and every gradient leaf within 5e-2 relative L2 error
(bf16 rounds at other places in the two frameworks; measured ~1.6e-05 and
≤ 1.8e-02).  Three training steps against the reference's ``build_step``:
losses within ``rtol=1e-2``.  AdamW on a nested tree: 1 ulp (the clip's
global norm sums in another float32 order).  Top-k compression and the
token pipeline: equal.  Checkpoints: the reference's cases of
``tests/test_checkpoint_restart.py`` mirrored, bf16 bit for bit.
"""
import os
import signal
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import tokens as rtokens
from repro.launch import train as rtrain
from repro.models import common as rcommon
from repro.models import lm as rlm
from repro.models import transformer as rtf
from repro.optim import adamw as radamw
from repro.optim import compression as rcomp

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import SHAPES, ShapeCell
from repro_torch.convert import lm_params_to_torch
from repro_torch.data import tokens as ttokens
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.optim.adamw import tree_leaves, tree_map

ARCH = "hymba-1.5b"
B, S, CHUNK = 2, 32, 16
GRAD_REL_L2 = 5e-2


def _ref_params(seed=0, draw_seed=7):
    cfg = rconfigs.get_reduced(ARCH)
    params = rlm.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(draw_seed)
    for stack in ("layers", "glayers"):
        for name in ("bc_w", "d_skip"):
            shape = params[stack][name].shape
            params[stack][name] = jnp.asarray(
                rng.standard_normal(shape) * 0.02, jnp.bfloat16)
    return params


def _t_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _grads(params, cfg, batch, **kw):
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = tlm.train_loss(p, cfg, batch, **kw)
    loss.backward()
    return loss.detach(), tree_map(lambda t: t.grad, p)


@pytest.fixture(scope="module")
def ref():
    cfg = rconfigs.get_reduced(ARCH)
    params = _ref_params()
    np_params = jax.tree.map(np.asarray, params)
    stream = np.random.default_rng(11).integers(0, cfg.vocab, (B, S + 1))
    batch = {"tokens": jnp.asarray(stream[:, :-1], jnp.int32),
             "labels": jnp.asarray(stream[:, 1:], jnp.int32)}
    loss, grads = jax.value_and_grad(
        lambda p: rlm.train_loss(p, cfg, batch, chunk=CHUNK))(params)
    return SimpleNamespace(cfg=cfg, tcfg=tconfigs.get_reduced(ARCH),
                           params=params, np_params=np_params,
                           tparams=lm_params_to_torch(np_params),
                           batch=batch, loss=float(loss),
                           grads=jax.tree.map(np.asarray, grads))


# ------------------------------------------------------------------- loss
def _grid(rng, shape):
    """Multiples of 1/4 in [−1, 1]: products over D ≤ 16 are exact in bf16
    in both frameworks, so the logits agree bit for bit."""
    return rng.integers(-4, 5, shape).astype(np.float32) / 4


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (2, 9))
    mask = (rng.random((2, 9)) < 0.6).astype(np.float32) if masked else None
    want = rcommon.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
    got = tcommon.softmax_xent(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_softcap_matches_reference():
    x = np.linspace(-80, 80, 33).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.softcap(torch.from_numpy(x), 30.0).numpy(),
        np.asarray(rcommon.softcap(jnp.asarray(x), 30.0)), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("Sq,chunk,cap,valid,head", [
    (32, 8, 0.0, None, False),
    (30, 8, 0.0, 37, False),          # S not a multiple of chunk → 3 × 10
    (37, 8, 0.0, None, False),        # prime S → one chunk
    (24, 8, 5.0, 40, False),          # logit softcap, masked vocab
    (24, 16, 0.0, 33, True),          # untied head
])
def test_chunked_xent_matches_reference(Sq, chunk, cap, valid, head):
    rng = np.random.default_rng(Sq + chunk)
    D, V = 16, 48
    x, embed = _grid(rng, (2, Sq, D)), _grid(rng, (V, D))
    lm_head = _grid(rng, (D, V)) if head else None
    labels = rng.integers(0, valid or V, (2, Sq))
    j = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)
    t = lambda a: None if a is None else torch.from_numpy(a).to(
        torch.bfloat16)
    want = rtf.chunked_xent(j(x), j(embed), jnp.asarray(labels),
                            logit_softcap=cap, chunk=chunk, lm_head=j(lm_head),
                            valid_vocab=valid)
    got = ttf.chunked_xent(t(x), t(embed), torch.from_numpy(labels),
                           logit_softcap=cap, chunk=chunk, lm_head=t(lm_head),
                           valid_vocab=valid)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -------------------------------------------------------- loss + gradient
def test_train_loss_and_grads_match_reference(ref):
    loss, grads = _grads(ref.tparams, ref.tcfg, _t_batch(ref.batch),
                         chunk=CHUNK)
    np.testing.assert_allclose(float(loss), ref.loss, rtol=1e-3)
    for g, p in zip(tree_leaves(grads), tree_leaves(ref.tparams)):
        assert g.dtype == p.dtype            # bf16, a_log float32
    worst = 0.0
    for path, want in jax.tree_util.tree_flatten_with_path(ref.grads)[0]:
        got = grads
        for k in path:
            got = got[k.key]
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= GRAD_REL_L2, (path, err)
        worst = max(worst, err)
    assert worst > 0          # the two frameworks round apart somewhere


def test_remat_does_not_change_loss_or_grads(ref):
    batch = _t_batch(ref.batch)
    l1, g1 = _grads(ref.tparams, ref.tcfg, batch, chunk=CHUNK, remat=True)
    l0, g0 = _grads(ref.tparams, ref.tcfg, batch, chunk=CHUNK, remat=False)
    assert torch.equal(l1, l0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)


def test_input_specs_match_reference(ref):
    for name, cell in SHAPES.items():
        want = rlm.input_specs(ref.cfg, cell)
        got = tlm.input_specs(ref.tcfg, cell)
        assert {k: tuple(v.shape) for k, v in want.items()} \
            == {k: v[0] for k, v in got.items()}, name
        assert all(v[1] == torch.int32 for v in got.values())
    with pytest.raises(ValueError, match="nope"):
        tlm.input_specs(tconfigs.get_reduced(ARCH).replace(family="nope"),
                        ShapeCell("x", 8, 1, "train"))


@pytest.mark.parametrize("compress", [0.0, 0.05])
def test_build_step_matches_reference(ref, compress):
    """Three steps of each package's ``build_step`` from the same
    parameters on ``batch_for_step`` batches."""
    opt = dict(lr=3e-3, grad_clip=1.0)
    r_step = rtrain.build_step(ref.cfg, radamw.AdamWConfig(**opt), compress)
    t_step = ttrain.build_step(ref.tcfg, tadamw.AdamWConfig(**opt), compress)
    r_p = jax.tree.map(jnp.asarray, ref.np_params)
    r_s = radamw.adamw_init(r_p)
    r_e = (rcomp.topk_compress_init(r_p) if compress
           else jnp.zeros((), jnp.float32))
    t_p = ref.tparams
    t_s = tadamw.adamw_init(t_p)
    t_e = (tcomp.topk_compress_init(t_p) if compress
           else torch.zeros((), dtype=torch.float32))
    want, got = [], []
    for step in range(3):
        batch = rtokens.batch_for_step(ref.cfg, B, 16, step, seed=1)
        r_p, r_s, r_e, loss = r_step(r_p, r_s, r_e, {
            k: jnp.asarray(v) for k, v in batch.items()})
        want.append(float(loss))
        t_p, t_s, t_e, loss = t_step(t_p, t_s, t_e, _t_batch(batch))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert t_s["step"] == 3
    assert all(p.dtype == q.dtype for p, q in
               zip(tree_leaves(t_p), tree_leaves(ref.tparams)))
    assert all(m.dtype == torch.float32 for m in tree_leaves(t_s["m"]))


# -------------------------------------------------------------- optimiser
def test_adamw_on_a_nested_tree_matches_reference():
    rng = np.random.default_rng(5)
    shapes = {"embed": (12, 4), "final_norm": {"w": (4,)},
              "layers": {"wq": (2, 4, 4), "a_log": (2, 4, 3),
                         "ln1": {"w": (2, 4)}}}
    draw = lambda: jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    p, g = draw(), draw()
    opt = dict(lr=5e-3, weight_decay=0.01, grad_clip=0.5)
    r_p, r_s = radamw.adamw_update(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        radamw.adamw_init(jax.tree.map(jnp.asarray, p)),
        radamw.AdamWConfig(**opt))
    tt = lambda tree: tree_map(torch.from_numpy, tree)
    t_p, t_s = tadamw.adamw_update(tt(p), tt(g), tadamw.adamw_init(tt(p)),
                                   tadamw.AdamWConfig(**opt))
    want = jax.tree_util.tree_flatten_with_path(r_p)[0]
    got = tree_leaves(t_p)
    assert len(got) == len(want)
    for (path, w), t in zip(want, got):
        np.testing.assert_array_max_ulp(np.asarray(w), t.numpy(), maxulp=1)
    for key in ("m", "v"):
        for w, t in zip(jax.tree.leaves(r_s[key]), tree_leaves(t_s[key])):
            np.testing.assert_array_max_ulp(np.asarray(w), t.numpy(),
                                            maxulp=1)
    # the global norm sums in jax.tree.leaves order
    gn = tadamw.global_norm(tt(g))
    np.testing.assert_array_max_ulp(
        np.asarray(radamw.global_norm(jax.tree.map(jnp.asarray, g))),
        gn.numpy(), maxulp=1)


def test_adamw_gnn_layout_unchanged():
    """The list-of-dicts layout keeps each layer's key order."""
    p = [{"w": torch.ones(2, 2), "b": torch.zeros(2)}]
    new, state = tadamw.adamw_update(p, p, tadamw.adamw_init(p),
                                     tadamw.AdamWConfig())
    assert isinstance(new, list) and list(new[0]) == ["w", "b"]
    assert list(state["m"][0]) == ["w", "b"] and state["step"] == 1


def test_topk_compress_is_bit_equal_to_reference():
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((40,)).astype(np.float32),
            "b": {"c": np.repeat(np.float32([0.5, -0.5, 0.25, 1.0]), 10)
                  .reshape(8, 5)},                       # ties at the cut
            "d": np.float32([[3.0]])}
    err = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1)
                       .astype(np.float32), tree)
    for frac in (0.05, 0.3, 0.5):
        r_sent, r_err = rcomp.topk_compress_apply(
            jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, err),
            frac)
        t_sent, t_err = tcomp.topk_compress_apply(
            tree_map(torch.from_numpy, tree), tree_map(torch.from_numpy, err),
            frac)
        for w, t in zip(jax.tree.leaves(r_sent) + jax.tree.leaves(r_err),
                        tree_leaves(t_sent) + tree_leaves(t_err)):
            np.testing.assert_array_equal(np.asarray(w), t.numpy())
    zero = tcomp.topk_compress_init(tree_map(torch.from_numpy, tree))
    assert all(z.dtype == torch.float32 and not z.any()
               for z in tree_leaves(zero))


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (1, 7), (3, 123)])
def test_batch_for_step_equals_reference(seed, step):
    for arch in (ARCH, "qwen2-72b"):
        cfg = rconfigs.get_reduced(arch)
        want = rtokens.batch_for_step(cfg, 4, 16, step, seed)
        got = ttokens.batch_for_step(cfg, 4, 16, step, seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------ checkpoints
# the reference's tests/test_checkpoint_restart.py, case for case
def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = {"a": torch.arange(5.0), "b": [torch.ones((2, 3)),
                                          torch.tensor(7, dtype=torch.int32)]}
    mgr.save(3, tree)
    step, back = mgr.restore()
    assert step == 3
    assert np.allclose(back["a"].numpy(), np.arange(5.0))
    assert int(back["b"][1]) == 7 and back["b"][1].dtype == torch.int32


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 5, 9):
        mgr.save(s, {"x": torch.tensor(float(s))})
    assert mgr.latest_step() == 9
    assert mgr.all_steps() == [5, 9]          # step 1 collected
    step, tree = mgr.restore()
    assert float(tree["x"]) == 9.0


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(2, {"x": torch.arange(10)})
    mgr.wait()
    step, tree = mgr.restore()
    assert step == 2 and np.allclose(tree["x"].numpy(), np.arange(10))


def test_data_pipeline_stateless():
    cfg = tconfigs.get_reduced(ARCH)
    b1 = ttokens.batch_for_step(cfg, 4, 16, step=7, seed=1)
    b2 = ttokens.batch_for_step(cfg, 4, 16, step=7, seed=1)
    b3 = ttokens.batch_for_step(cfg, 4, 16, step=8, seed=1)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_crash_mid_save_keeps_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"x": torch.tensor(1.0)})
    # simulate a crash that left a stale tmp dir
    os.makedirs(os.path.join(str(tmp_path), ".tmp_step_2"), exist_ok=True)
    assert mgr.latest_step() == 1
    step, tree = mgr.restore()
    assert step == 1 and float(tree["x"]) == 1.0


def test_training_state_round_trips_bit_for_bit(tmp_path):
    """(params, AdamW state, error) as ``launch/train.py`` saves it: bf16
    leaves as their bit pattern, float32 ``a_log``, Python ints."""
    params = lm_params_to_torch(jax.tree.map(np.asarray, _ref_params()))
    state = tadamw.adamw_init(params)
    state["step"] = 12
    tree = (params, state, torch.zeros((), dtype=torch.float32))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(12, tree)
    step, back = mgr.restore(device="cpu")
    assert step == 12 and isinstance(back, tuple)
    assert back[1]["step"] == 12
    tensors = lambda t: [x for x in tree_leaves(t)
                         if isinstance(x, torch.Tensor)]
    want, got = tensors(tree), tensors(back)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype == torch.bfloat16:
            assert torch.equal(g.view(torch.int16), w.view(torch.int16))
        else:
            assert torch.equal(g, w)
    assert any(w.dtype == torch.bfloat16 for w in want)


def test_restore_of_an_empty_directory(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore() == (None, None)


# ------------------------------------------------------- the train entry
def test_launchers_agree_at_the_cli_lr(monkeypatch):
    """Both packages' ``launch.train`` on reduced hymba at the CLI's
    default lr 3e-3, 10 steps at batch 4 and length 32, from the same
    seed: the port's launcher starts from the reference's
    ``init_params(PRNGKey(0))`` (carried across bit for bit) and reads
    the same ``batch_for_step`` batches, so its losses follow the
    reference's within ``test_build_step_matches_reference``'s
    ``rtol=1e-2`` and fall alike."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "10", "--lr", "3e-3",
            "--batch", "4", "--seq", "32", "--log-every", "100"]
    want = rtrain.train(argv)
    ref_params = jax.tree.map(np.asarray, rlm.init_params(
        jax.random.PRNGKey(0), rconfigs.get_reduced(ARCH)))
    monkeypatch.setattr(ttrain.lm, "init_params",
                        lambda cfg, *, generator, device:
                        lm_params_to_torch(ref_params, device))
    got = ttrain.train(argv + ["--device", "cpu"])
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert got[-1] < got[0] and want[-1] < want[0]


def _cli(*extra):
    return ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--log-every", "100", *extra]


def test_train_restart_continuity(tmp_path, capsys):
    """Kill and resume: the resumed run's losses are the uninterrupted
    run's (the reference's ``test_train_restart_continuity``, on the
    port's CPU path at a size that runs in seconds)."""
    full = ttrain.train(_cli("--steps", "8"))
    ck = str(tmp_path / "ck")
    first = ttrain.train(_cli("--steps", "5", "--ckpt-dir", ck,
                              "--ckpt-every", "2"))
    capsys.readouterr()
    resumed = ttrain.train(_cli("--steps", "8", "--ckpt-dir", ck,
                                "--resume"))
    assert "resumed from step 4" in capsys.readouterr().out
    assert len(full) == 8 and len(resumed) == 3
    np.testing.assert_allclose(first, full[:5], rtol=0)
    np.testing.assert_allclose(resumed, full[5:], rtol=1e-3)
    assert full[-1] < full[0]
    assert CheckpointManager(ck).all_steps() == [2, 4, 7]


def test_train_checkpoints_on_sigterm(tmp_path, monkeypatch, capsys):
    """SIGTERM mid-run: the step in hand is checkpointed and the process
    exits cleanly; a resume continues from it."""
    ck = str(tmp_path / "ck")
    real = ttrain.build_step

    def build(*a, **kw):
        step_fn = real(*a, **kw)

        def step(*args):
            out = step_fn(*args)
            if step.calls == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            step.calls += 1
            return out
        step.calls = 0
        return step

    monkeypatch.setattr(ttrain, "build_step", build)
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        ttrain.train(_cli("--steps", "6", "--ckpt-dir", ck,
                          "--ckpt-every", "50"))
    assert exc.value.code == 0
    assert "SIGTERM: checkpointed at step 1" in capsys.readouterr().out
    assert CheckpointManager(ck).latest_step() == 1
    assert signal.getsignal(signal.SIGTERM) is before
