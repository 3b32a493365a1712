"""PyTorch port vs JAX reference: the ``ssm_scan_dtype="bfloat16"`` perf
option through Hymba's mamba branch, prefill, decode and training.

Under the option both packages build A, dA and dBx in bf16
(``repro/models/ssm.py:62-67``).  The port then scans them in float32,
as the reference's Pallas route does (``ssm_backend="pallas"``: its
wrapper casts them to float32 before its float32 kernel); the
reference's default XLA route combines them in bf16.  So the port's
function under the option is the Pallas route's, and it is held to that
route tightly and to the XLA route within the reference's own gap
between its two routes.

* The branch, with float32 weights and input (then the option's cast is
  the only bf16 rounding in either package), against the Pallas route
  under the option within ``BRANCH_ATOL = 1e-4`` (measured 9.5e-7, at
  max |y| 3.36); the reference's runs under bf16 and float32 lie more
  than 10 × that apart (measured 9.4e-3), so a port that ignored the
  option would fail.  Against the XLA route under the option: within
  the reference's own XLA-to-Pallas gap on the same inputs (measured
  7.9e-3; held below ``ROUTE_GAP_MAX``) plus ``BRANCH_ATOL``.
* The operands the branch hands to ``selective_scan``: float32 tensors
  whose values are bf16's under the option, the float32 build (not all
  bf16 values) under the default.
* Decode at float32 weights: y and the new float32 state against the
  reference's decode under the option within ``BRANCH_ATOL``.
* The reduced model at bf16 weights (``tests/test_torch_lm.py``'s):
  ``forward_hidden`` and ``prefill`` against both routes, and 8
  teacher-forced decode steps with their caches, at that file's
  ``MODEL_TOL``; ``train_loss`` and its gradients against the XLA route
  (the Pallas route has no gradient) at ``tests/test_torch_lm_train.py``'s
  tolerances: the loss within ``rtol=1e-3``, each leaf within 5e-2
  relative L2.
"""
import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.models import common as rcommon
from repro.models import lm as rlm
from repro.models import ssm as rssm
from repro.models import transformer as rtf

from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_params_to_torch
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.optim.adamw import tree_map

from test_torch_lm import MODEL_TOL, _ref_params, _valid
from test_torch_lm_train import GRAD_REL_L2

ARCH = "hymba-1.5b"
BF16 = "bfloat16"
BRANCH_ATOL = 1e-4
ROUTE_GAP_MAX = 2e-2          # the reference's XLA-to-Pallas gap, bounded
LOSS_RTOL = 1e-3
B, S, CHUNK = 2, 32, 16
DECODE_STEPS = 8


def _np(x):
    return np.asarray(x, np.float32)


@contextlib.contextmanager
def _options(dtype, backend="xla"):
    """Both packages' perf options set for the block, reset after it."""
    rcommon.reset_perf_options()
    rcommon.set_perf_options(ssm_scan_dtype=dtype, ssm_backend=backend)
    tcommon.set_perf_options(ssm_scan_dtype=dtype)
    try:
        yield
    finally:
        rcommon.reset_perf_options()
        tcommon.reset_perf_options()


# ------------------------------------------------------------ the branch
@pytest.fixture(scope="module")
def branch():
    """One live mamba layer (``test_torch_lm.py::_live_mamba_layer``'s
    scales) with float32 weights, a float32 input (B = 2, S = 64), and
    the reference's branch under each option and route."""
    cfg = rconfigs.get_reduced(ARCH)
    D, N = cfg.d_model, cfg.ssm_state
    Di = cfg.ssm_expand * D
    rng = np.random.default_rng(3)
    scales = {"in_proj": ((D, 2 * Di), D ** -0.5), "conv_w": ((4, Di), 0.5),
              "dt_a": ((Di, 64), Di ** -0.5), "dt_proj": ((64, Di), 0.125),
              "dt_b": ((Di,), 0.5), "bc_w": ((Di, 2 * N), Di ** -0.5),
              "d_skip": ((Di,), 1.0), "out_proj": ((Di, D), Di ** -0.5)}
    lp = {k: (rng.standard_normal(s) * sc).astype(np.float32)
          for k, (s, sc) in scales.items()}
    lp["a_log"] = np.log(np.broadcast_to(
        np.arange(1, N + 1, dtype=np.float32), (Di, N))).copy()
    x = rng.standard_normal((2, 64, D)).astype(np.float32)
    conv = rng.standard_normal((2, 3, Di)).astype(np.float32)
    ssm = rng.standard_normal((2, Di, N)).astype(np.float32)
    jlp = {k: jnp.asarray(v) for k, v in lp.items()}
    want = {}
    # each jitted afresh inside its options: they are read when it traces
    for dtype in ("float32", BF16):
        for backend in ("xla", "pallas"):
            with _options(dtype, backend):
                want[dtype, backend] = _np(jax.jit(
                    lambda a: rssm.mamba_branch(a, jlp, cfg))(
                        jnp.asarray(x)))
        with _options(dtype):
            want[dtype, "decode"] = [_np(a) for a in jax.jit(
                lambda a, c, h: rssm.mamba_branch(
                    a, jlp, cfg, conv_state=c, ssm_state=h))(
                jnp.asarray(x[:, :1]), jnp.asarray(conv), jnp.asarray(ssm))]
    return SimpleNamespace(
        tcfg=tconfigs.get_reduced(ARCH), x=x, conv=conv, ssm=ssm, want=want,
        tlp={k: torch.from_numpy(v) for k, v in lp.items()})


def _port_branch(b, dtype, x=None, **kw):
    x = b.x if x is None else x
    with _options(dtype):
        return tssm.mamba_branch(torch.from_numpy(x), b.tlp, b.tcfg, **kw)


def test_branch_matches_reference_pallas_route(branch):
    """Held to the Pallas route under the option; the option itself moves
    the reference's branch more than 10 × the tolerance."""
    got = _port_branch(branch, BF16).numpy()
    want = branch.want[BF16, "pallas"]
    assert np.abs(want).max() > 1.0                  # the branch is live
    np.testing.assert_allclose(got, want, atol=BRANCH_ATOL, rtol=0)
    moved = np.abs(want - branch.want["float32", "pallas"]).max()
    assert moved > 10 * BRANCH_ATOL, moved


def test_branch_within_reference_route_gap_of_xla_route(branch):
    """Against the XLA route (bf16 combine): within the reference's own
    gap between its XLA and Pallas routes under the option, plus the
    Pallas tolerance."""
    gap = np.abs(branch.want[BF16, "xla"] - branch.want[BF16, "pallas"]).max()
    assert 0 < gap < ROUTE_GAP_MAX, gap
    got = _port_branch(branch, BF16).numpy()
    np.testing.assert_allclose(got, branch.want[BF16, "xla"],
                               atol=gap + BRANCH_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", BF16])
def test_scan_operands_follow_the_option(branch, monkeypatch, dtype):
    """What the branch hands to ``selective_scan``: float32 tensors,
    holding bf16 values under the option and the float32 build under the
    default, each equal to the reference's build (``repro/models/ssm.py:
    64-67``, in its (B, S, Di, N) layout) transposed."""
    seen = []
    real = tssm.selective_scan

    def spy(dA, dBx, C):
        seen.append((dA, dBx, C))
        return real(dA, dBx, C)

    monkeypatch.setattr(tssm, "selective_scan", spy)
    _port_branch(branch, dtype)
    (dA, dBx, C), = seen
    assert all(t.dtype == torch.float32 for t in (dA, dBx, C))
    as_bf16 = lambda t: torch.equal(t.to(torch.bfloat16).float(), t)
    assert as_bf16(dA) == as_bf16(dBx) == (dtype == BF16)
    lp, cfg = branch.tlp, branch.tcfg
    Di, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    F = torch.nn.functional
    xi = F.silu(tssm._causal_conv(
        (torch.from_numpy(branch.x) @ lp["in_proj"])[..., :Di],
        lp["conv_w"]))
    dt = F.softplus((xi @ lp["dt_a"]) @ lp["dt_proj"] + lp["dt_b"])
    Bm = (xi @ lp["bc_w"])[..., :N]
    sdt = getattr(torch, dtype)
    A = (-torch.exp(lp["a_log"])).to(sdt)
    want_dA = torch.exp(dt.to(sdt)[..., None] * A)
    want_dBx = (dt * xi).to(sdt)[..., None] * Bm.to(sdt)[..., None, :]
    assert torch.equal(dA, want_dA.float().transpose(2, 3))
    assert torch.equal(dBx, want_dBx.float().transpose(2, 3))


def test_decode_matches_reference(branch):
    """One decode step under the option: y and the new float32 state
    against the reference's, the conv window equal."""
    y, conv, h = _port_branch(branch, BF16, branch.x[:, :1],
                              conv_state=torch.from_numpy(branch.conv),
                              ssm_state=torch.from_numpy(branch.ssm))
    wy, wconv, wh = branch.want[BF16, "decode"]
    assert h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), wy, atol=BRANCH_ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), wh, atol=BRANCH_ATOL, rtol=0)
    np.testing.assert_allclose(conv.numpy(), wconv, atol=BRANCH_ATOL, rtol=0)
    moved = np.abs(wh - branch.want["float32", "decode"][2]).max()
    assert moved > 10 * BRANCH_ATOL, moved


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def model():
    """Reduced Hymba at bf16 weights (``test_torch_lm.py``'s), and the
    reference's results under the option: each route's hidden states and
    last-token logits, 8 decode steps, and ``train_loss`` with its
    gradients (XLA route)."""
    cfg = rconfigs.get_reduced(ARCH)
    params = _ref_params()
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (B, S + 1))
    batch = {"tokens": jnp.asarray(tokens[:, :-1], jnp.int32)}
    hidden, logits = {}, {}
    # each jitted afresh inside the options: they are read when it traces
    for backend in ("xla", "pallas"):
        with _options(BF16, backend):
            h = jax.jit(lambda p, b: rlm.forward_hidden(
                p, cfg, b, remat=False, chunk=CHUNK))(params, batch)
            hidden[backend] = _np(h)
            logits[backend] = _np(rtf.logits_for(h[:, -1:], params, cfg))
    with _options(BF16):
        cell = rbase.ShapeCell("d", DECODE_STEPS, B, "decode")
        cache = rlm.init_cache(cfg, cell)
        step = jax.jit(lambda p, t, c, pos: rlm.decode_step(p, cfg, t, c,
                                                            pos))
        dec = []
        for t in range(DECODE_STEPS):
            out, cache = step(params, batch["tokens"][:, t:t + 1], cache,
                              jnp.int32(t))
            dec.append(_np(out))
        train = {"tokens": batch["tokens"],
                 "labels": jnp.asarray(tokens[:, 1:], jnp.int32)}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: rlm.train_loss(p, cfg, train, chunk=CHUNK)))(params)
    return SimpleNamespace(
        tcfg=tconfigs.get_reduced(ARCH), tokens=tokens, hidden=hidden,
        logits=logits, decode=dec, cache={k: _np(v) for k, v in
                                          cache.items()},
        loss=float(loss), grads=jax.tree.map(np.asarray, grads),
        tparams=lm_params_to_torch(jax.tree.map(np.asarray, params)))


def _t_tokens(m, n=S):
    return torch.as_tensor(m.tokens[:, :n])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_forward_hidden_matches_reference(model, backend):
    with _options(BF16):
        got = tlm.forward_hidden(model.tparams, model.tcfg,
                                 {"tokens": _t_tokens(model)}, chunk=CHUNK)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), model.hidden[backend],
                               **MODEL_TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_prefill_matches_reference(model, backend):
    with _options(BF16):
        got = tlm.prefill(model.tparams, model.tcfg,
                          {"tokens": _t_tokens(model)}, chunk=CHUNK)
    want = model.logits[backend]
    m = _valid(want)
    np.testing.assert_allclose(got.numpy()[m], want[m], **MODEL_TOL)


def test_decode_steps_and_caches_match_reference(model):
    """Teacher-forced decode steps past the reduced window of 8 cannot
    fit in ``DECODE_STEPS`` = 8 slots, so the ring is held at its edge:
    every step's logits and every cache tensor at the end."""
    cache = tlm.init_cache(model.tcfg, tbase.ShapeCell(
        "d", DECODE_STEPS, B, "decode"), device="cpu")
    with _options(BF16):
        for t in range(DECODE_STEPS):
            got, cache = tlm.decode_step(model.tparams, model.tcfg,
                                         _t_tokens(model)[:, t:t + 1],
                                         cache, t)
            want = model.decode[t]
            m = _valid(want)
            np.testing.assert_allclose(got.numpy()[m], want[m], **MODEL_TOL)
    for name, want in model.cache.items():
        np.testing.assert_allclose(cache[name].float().numpy(), want,
                                   **MODEL_TOL, err_msg=name)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_train_loss_and_grads_match_reference(model):
    batch = {"tokens": _t_tokens(model),
             "labels": torch.as_tensor(model.tokens[:, 1:])}
    p = tree_map(lambda t: t.detach().requires_grad_(), model.tparams)
    with _options(BF16):          # the remat recomputes under it too
        loss = tlm.train_loss(p, model.tcfg, batch, chunk=CHUNK)
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), model.loss,
                               rtol=LOSS_RTOL)

    def walk(got, want, path=()):
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for k in want:
                walk(got[k], want[k], path + (k,))
            return
        err = _rel_l2(got.grad.float().numpy(), want.astype(np.float32))
        assert err < GRAD_REL_L2, ("/".join(path), err)

    walk(p, model.grads)
