"""PyTorch port vs JAX reference: RWKV6's building blocks
(``models/ssm.py``: ``_token_shift``, ``_wkv6``, the time mix, the channel
mix and the whole layer).

``_wkv6`` runs on seeded float32 r/k/v, decays w ∈ (0, 1) and a bonus u,
from zeros and from a given state, at S ∈ {1, 17}: y and the final state
within ``rtol = atol = 1e-5`` of the reference's ``lax.scan`` (the port
forms the bonus term for all steps at once, so its float32 sums round
apart by ulps).  The mixes and the layer run at the reduced width
(d_model 128, two heads of 64, d_ff 256) on one layer of the reference's
``init_params`` with its matrices, decays, bonus and mixing weights
redrawn from numpy at live scales (at the N(0, 0.02) init the WKV term
adds almost nothing to the layer's output), in bf16 with float32
islands: within the reference's bf16 tolerance ``atol = rtol = 5e-2``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import lm as rlm
from repro.models import ssm as rssm

from repro_torch.convert import lm_params_to_torch
from repro_torch.models import ssm as tssm

WKV_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=5e-2, rtol=5e-2)
ARCH = "rwkv6-1.6b"
B, S = 2, 12
HD = rssm.RWKV_HEAD_DIM


def _np(x):
    return np.asarray(x, np.float32)


def _bf16(a):
    """numpy → (jax bf16, torch bf16) of the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def live_layer(seed=0):
    """One reduced RWKV6 layer (the reference's ``init_params``, layer 0)
    with live weights: matrices N(0, 1/fan_in), the decay's bias in
    (−3, 1), the bonus N(0, 0.5), mixing weights in (0, 1), norm weights
    and biases near 1 and 0.  Returns (jax dict, torch dict)."""
    cfg = rconfigs.get_reduced(ARCH)
    params = rlm.init_params(jax.random.PRNGKey(seed), cfg)["layers"]
    lp = jax.tree.map(lambda a: np.asarray(a[0]), params)
    rng = np.random.default_rng(seed + 10)
    for name in ("wr", "wk", "wv", "wg", "wo", "w_lora_a", "w_lora_b",
                 "cm_k", "cm_v", "cm_r"):
        shape = lp[name].shape
        lp[name] = rng.standard_normal(shape) / np.sqrt(shape[0])
    lp["w_bias"] = rng.uniform(-3, 1, lp["w_bias"].shape)
    lp["u_bonus"] = rng.standard_normal(lp["u_bonus"].shape) * 0.5
    lp["mu"] = rng.uniform(0, 1, lp["mu"].shape)
    lp["cm_mu"] = rng.uniform(0, 1, lp["cm_mu"].shape)
    for ln in ("ln1", "ln2"):
        lp[ln] = {"w": 1 + 0.1 * rng.standard_normal(lp[ln]["w"].shape),
                  "b": 0.1 * rng.standard_normal(lp[ln]["b"].shape)}
    j = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), lp)
    return j, lm_params_to_torch(jax.tree.map(np.asarray, j))


def _x(seed, shape=(B, S, 128)):
    return _bf16(np.random.default_rng(seed).standard_normal(shape))


# ---------------------------------------------------------- token shift
@pytest.mark.parametrize("with_last", [False, True])
def test_token_shift_matches_reference(with_last):
    jx, tx = _x(1)
    if with_last:
        jl, tl = _x(2, (B, 1, 128))
        want, got = rssm._token_shift(jx, jl), tssm._token_shift(tx, tl)
        assert got is tl
    else:
        want, got = rssm._token_shift(jx), tssm._token_shift(tx)
        assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


# ----------------------------------------------------------------- WKV6
def _wkv_inputs(seed, S, H=2):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, HD)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.05, 0.999, (B, S, H, HD)).astype(np.float32)
    u = rng.standard_normal((H, HD)).astype(np.float32)
    state = rng.standard_normal((B, H, HD, HD)).astype(np.float32)
    return r, k, v, w, u, state


@pytest.mark.parametrize("S", [1, 17])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_matches_reference(S, with_state):
    r, k, v, w, u, state = _wkv_inputs(S + 3 * with_state, S)
    st = state if with_state else None
    y_want, s_want = rssm._wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                                None if st is None else jnp.asarray(st))
    t = lambda a: None if a is None else torch.from_numpy(a)
    y, s = tssm._wkv6(t(r), t(k), t(v), t(w), t(u), t(st))
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == (B, S, 2, HD) and tuple(s.shape) == (B, 2, HD,
                                                                  HD)
    np.testing.assert_allclose(y.numpy(), _np(y_want), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), _np(s_want), **WKV_TOL)


def test_wkv6_bf16_inputs_and_u_widen_as_the_reference():
    """bf16 r/k/v and a bf16 u (as the time mix passes them): widened to
    float32 before any product."""
    r, k, v, w, u, _ = _wkv_inputs(5, 9)
    js = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)]
    ts = [torch.from_numpy(_np(a)).to(torch.bfloat16) for a in js]
    ju, tu = _bf16(u)
    y_want, s_want = rssm._wkv6(*js, jnp.asarray(w), ju)
    y, s = tssm._wkv6(*ts, torch.from_numpy(w), tu)
    np.testing.assert_allclose(y.numpy(), _np(y_want), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), _np(s_want), **WKV_TOL)


def test_wkv6_state_splits_the_sequence():
    """Two calls over halves, the second from the first's state, equal one
    call over the whole (the decode cache's contract)."""
    r, k, v, w, u, state = _wkv_inputs(7, 16)
    t = [torch.from_numpy(a) for a in (r, k, v, w)]
    y, s = tssm._wkv6(*t, torch.from_numpy(u), torch.from_numpy(state))
    y1, s1 = tssm._wkv6(*(a[:, :9] for a in t), torch.from_numpy(u),
                        torch.from_numpy(state))
    y2, s2 = tssm._wkv6(*(a[:, 9:] for a in t), torch.from_numpy(u), s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **WKV_TOL)
    torch.testing.assert_close(s2, s, **WKV_TOL)


# ------------------------------------------------------------ the mixes
@pytest.fixture(scope="module")
def layer():
    return live_layer()


@pytest.mark.parametrize("decode", [False, True])
def test_time_mix_matches_reference(layer, decode):
    jl, tl = layer
    Sx = 1 if decode else S
    jx, tx = _x(3, (B, Sx, 128))
    kw_j, kw_t = {}, {}
    if decode:
        jlast, tlast = _x(4, (B, 1, 128))
        rng = np.random.default_rng(5)
        st = rng.standard_normal((B, 2, HD, HD)).astype(np.float32)
        kw_j = dict(last=jlast, state=jnp.asarray(st))
        kw_t = dict(last=tlast, state=torch.from_numpy(st))
    want, ws = rssm.rwkv_time_mix(jx, jl, **kw_j)
    got, gs = tssm.rwkv_time_mix(tx, tl, **kw_t)
    assert got.dtype == torch.bfloat16 and gs.dtype == torch.float32
    assert np.abs(_np(want)).max() > 0.5        # the mix carries signal
    np.testing.assert_allclose(got.float().numpy(), _np(want), **MODEL_TOL)
    np.testing.assert_allclose(gs.numpy(), _np(ws), **MODEL_TOL)


@pytest.mark.parametrize("decode", [False, True])
def test_channel_mix_matches_reference(layer, decode):
    jl, tl = layer
    jx, tx = _x(6, (B, 1 if decode else S, 128))
    if decode:
        jlast, tlast = _x(7, (B, 1, 128))
        want = rssm.rwkv_channel_mix(jx, jl, last=jlast)
        got = tssm.rwkv_channel_mix(tx, tl, last=tlast)
    else:
        want = rssm.rwkv_channel_mix(jx, jl)
        got = tssm.rwkv_channel_mix(tx, tl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), **MODEL_TOL)


def test_layer_matches_reference(layer):
    jl, tl = layer
    jx, tx = _x(8)
    want, none = rssm.rwkv_layer(jx, jl)
    got, tnone = tssm.rwkv_layer(tx, tl)
    assert none is None and tnone is None
    np.testing.assert_allclose(got.float().numpy(), _np(want), **MODEL_TOL)


def test_layer_decode_states_match_reference(layer):
    """Decode mode (S = 1 from given states): the output and the three new
    states, which are the mixes' normed inputs (not the residual) and
    the WKV state."""
    jl, tl = layer
    jx, tx = _x(9, (B, 1, 128))
    (j1, t1), (j2, t2) = _x(10, (B, 1, 128)), _x(11, (B, 1, 128))
    st = np.random.default_rng(12).standard_normal(
        (B, 2, HD, HD)).astype(np.float32)
    want, wstates = rssm.rwkv_layer(jx, jl, states=(j1, jnp.asarray(st), j2))
    got, gstates = tssm.rwkv_layer(tx, tl, states=(t1, torch.from_numpy(st),
                                                   t2))
    np.testing.assert_allclose(got.float().numpy(), _np(want), **MODEL_TOL)
    for g, w in zip(gstates, wstates):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), _np(w), **MODEL_TOL)
    np.testing.assert_allclose(
        gstates[0].float().numpy(), _np(rssm.apply_norm(jx, jl["ln1"],
                                                        "layernorm")),
        **MODEL_TOL)


def test_decode_steps_reproduce_the_sequence(layer):
    """The port's layer stepped token by token through its states equals
    its own whole-sequence layer (the reference's decode-vs-forward
    tolerance ``atol=0.15, rtol=0.05``)."""
    _, tl = layer
    _, tx = _x(13)
    whole, _ = tssm.rwkv_layer(tx, tl)
    last1 = last2 = torch.zeros(B, 1, 128, dtype=torch.bfloat16)
    wkv = torch.zeros(B, 2, HD, HD)
    outs = []
    for t in range(S):
        y, (last1, wkv, last2) = tssm.rwkv_layer(tx[:, t:t + 1], tl,
                                                 states=(last1, wkv, last2))
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1).float(), whole.float(),
                               atol=0.15, rtol=0.05)
