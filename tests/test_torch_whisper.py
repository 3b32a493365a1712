"""PyTorch port vs JAX reference: Whisper's building blocks
(``models/whisper.py``, ``common.plain_mlp`` and the non-causal path of
``transformer.chunked_attention``).

``plain_mlp`` is bit for bit the reference's in bf16 (``gelu_tanh`` is
``jax.nn.gelu``'s op-by-op form).  Non-causal attention scores every
query chunk against all of K/V: held with Sq > chunk and Sk ≠ Sq against
the reference's ``chunked_attention(causal=False)``.  ``_mha`` as
self-attention (causal and not), as cross-attention and as cached decode
attention, and the encoder, the teacher-forced decoder and one decode
step run on the reduced config (d_model 64, two heads of 32, d_ff 128)
with live weights (``live_whisper``: the reference's ``init_params``,
every projection redrawn N(0, 1/fan_in) and every bias N(0, 0.1)), in
bf16 with float32 islands: within the reference's bf16 tolerance ``atol
= rtol = 5e-2``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import common as rcommon
from repro.models import lm as rlm
from repro.models import transformer as rtf
from repro.models import whisper as rwh

from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_to_torch
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.models import whisper as twh

ARCH = "whisper-tiny"
MODEL_TOL = dict(atol=5e-2, rtol=5e-2)
B, SA, ST = 2, 32, 12


def _np(x):
    return np.asarray(x, np.float32)


def _bf16(a):
    """numpy → (jax bf16, torch bf16) of the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _draw(seed, *shape, scale=1.0):
    return _bf16(np.random.default_rng(seed).standard_normal(shape) * scale)


def live_whisper(seed=0):
    """The reduced Whisper of the reference's ``init_params`` with every
    projection of ``enc``/``dec`` N(0, 1/fan_in) and every bias N(0, 0.1)
    (the init zeroes ``b*``), norms near 1 and 0.  Returns (jax params,
    torch params)."""
    cfg = rconfigs.get_reduced(ARCH)
    params = jax.tree.map(np.asarray, rlm.init_params(
        jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 20)
    for stack in ("enc", "dec"):
        for name, a in params[stack].items():
            if isinstance(a, dict):                       # layernorm
                params[stack][name] = {
                    "w": 1 + 0.1 * rng.standard_normal(a["w"].shape),
                    "b": 0.1 * rng.standard_normal(a["b"].shape)}
            elif a.ndim == 3:
                params[stack][name] = (rng.standard_normal(a.shape)
                                       / np.sqrt(a.shape[1]))
            else:
                params[stack][name] = 0.1 * rng.standard_normal(a.shape)
    j = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    return j, lm_params_to_torch(jax.tree.map(np.asarray, j))


@pytest.fixture(scope="module")
def model():
    return live_whisper()


def _layer(params, stack, i=0):
    return (jax.tree.map(lambda a: a[i], params[0][stack]),
            {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                 else v[i]) for k, v in params[1][stack].items()})


# ------------------------------------------------------------------ MLP
def test_plain_mlp_is_bit_for_bit():
    (jx, tx), (jw1, tw1), (jb1, tb1), (jw2, tw2), (jb2, tb2) = (
        _draw(1, B, SA, 64), _draw(2, 64, 128, scale=0.2),
        _draw(3, 128, scale=0.5), _draw(4, 128, 64, scale=0.1),
        _draw(5, 64, scale=0.5))
    want = rcommon.plain_mlp(jx, jw1, jb1, jw2, jb2)
    got = tcommon.plain_mlp(tx, tw1, tb1, tw2, tb2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("Sq,Sk,chunk", [(32, 20, 8), (16, 48, 8),
                                         (12, 12, 16)])
@pytest.mark.parametrize("kv", [2, 1])
def test_noncausal_chunked_attention_matches_reference(Sq, Sk, chunk, kv):
    """Every chunk against all of K/V (Sq > chunk: several chunks; Sk
    shorter and longer than Sq; GQA with one KV head)."""
    (jq, tq), (jk, tk), (jv, tv) = (_draw(6, B, Sq, 2, 32),
                                    _draw(7, B, Sk, kv, 32),
                                    _draw(8, B, Sk, kv, 32))
    want = rtf.chunked_attention(jq, jk, jv, causal=False, chunk=chunk)
    got = ttf.chunked_attention(tq, tk, tv, causal=False, chunk=chunk)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=2e-2,
                               rtol=2e-2)
    one = ttf.chunked_attention(tq, tk, tv, causal=False, chunk=max(Sq, Sk))
    torch.testing.assert_close(got, one, atol=2e-2, rtol=2e-2)


def test_noncausal_attention_sees_the_last_key():
    """A query attends to keys past its own position: a spike in the last
    value row moves every query's output without the causal mask, and
    none but the last query's with it."""
    _, tq = _draw(9, 1, 16, 2, 32)
    k = torch.zeros(1, 16, 2, 32, dtype=torch.bfloat16)
    v = torch.zeros(1, 16, 2, 32, dtype=torch.bfloat16)
    v[:, -1] = 16.0
    out = ttf.chunked_attention(tq, k, v, causal=False, chunk=8)
    causal = ttf.chunked_attention(tq, k, v, causal=True, chunk=8)
    assert bool((out[:, :-1] > 0.5).all())
    assert bool((causal[:, :-1] == 0).all())


@pytest.mark.parametrize("how", ["self", "causal_self", "cross", "cached"])
def test_mha_matches_reference(model, how):
    cfg, tcfg = rconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jl, tl = _layer(model, "dec")
    jh, th = _draw(10, B, 1 if how == "cached" else ST, 64)
    if how == "cached":
        pos = 5
        (jk, tk), (jv, tv) = _draw(11, B, ST, 2, 32), _draw(12, B, ST, 2, 32)
        want, (wk, wv) = rwh._mha(jh, jl, "", cfg, causal=True,
                                  cache=(jk, jv), pos=jnp.int32(pos))
        got, (gk, gv) = twh._mha(th, tl, "", tcfg, causal=True,
                                 cache=(tk, tv), pos=torch.tensor(pos))
        assert gk is tk and gv is tv                       # in place
        np.testing.assert_allclose(gk.float().numpy(), _np(wk), **MODEL_TOL)
        np.testing.assert_allclose(gv.float().numpy(), _np(wv), **MODEL_TOL)
    elif how == "cross":
        jx, tx = _draw(13, B, SA, 64)
        want, _ = rwh._mha(jh, jl, "x", cfg, kv_src=jx, causal=False,
                           chunk=4)
        got, _ = twh._mha(th, tl, "x", tcfg, kv_src=tx, causal=False,
                          chunk=4)
    else:
        causal = how == "causal_self"
        want, _ = rwh._mha(jh, jl, "", cfg, causal=causal, chunk=4)
        got, _ = twh._mha(th, tl, "", tcfg, causal=causal, chunk=4)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), _np(want), **MODEL_TOL)


# ------------------------------------------------------- encoder/decoder
@pytest.fixture(scope="module")
def encoded(model):
    cfg = rconfigs.get_reduced(ARCH)
    jf, tf = _draw(14, B, SA, 64)
    want = rwh.whisper_encode(model[0], cfg, jf, remat=False, chunk=16)
    return jf, tf, want


@pytest.mark.parametrize("remat", [False, True])
def test_whisper_encode_matches_reference(model, encoded, remat):
    _, tf, want = encoded
    got = twh.whisper_encode(model[1], tconfigs.get_reduced(ARCH), tf,
                             remat=remat, chunk=16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), _np(want), **MODEL_TOL)


def _tokens(seed=15, n=ST):
    return np.random.default_rng(seed).integers(0, 256, (B, n))


def test_whisper_decode_train_matches_reference(model, encoded):
    jf, tf, jenc = encoded
    cfg, tcfg = rconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    tokens = _tokens()
    want = rwh.whisper_decode_train(model[0], cfg, jnp.asarray(tokens),
                                    jenc, remat=False, chunk=4)
    tenc = torch.from_numpy(_np(jenc)).to(torch.bfloat16)
    got = twh.whisper_decode_train(model[1], tcfg, torch.as_tensor(tokens),
                                   tenc, remat=False, chunk=4)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, ST, 64)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **MODEL_TOL)


def cross_cache(params, cfg, enc, steps):
    """The reference test's decode cache (``tests/test_models_lm.py::
    test_whisper_decode_matches_forward``): self-attention K/V zeros of
    ``steps`` slots, cross-attention K/V built from the encoder's states
    ``enc`` per layer (k without a bias, v with ``xbv``), in bf16; of jax
    arrays or of tensors, as ``enc`` is."""
    Bq, Sa = enc.shape[:2]
    L, kv, hd = cfg.n_layers, cfg.n_kv, cfg.head_dim
    dec = params["dec"]
    xk = [(enc @ dec["xwk"][i]).reshape(Bq, Sa, kv, hd) for i in range(L)]
    xv = [(enc @ dec["xwv"][i] + dec["xbv"][i]).reshape(Bq, Sa, kv, hd)
          for i in range(L)]
    shape = (L, Bq, steps, kv, hd)
    if isinstance(enc, torch.Tensor):
        bf = torch.bfloat16
        return {"k": torch.zeros(shape, dtype=bf),
                "v": torch.zeros(shape, dtype=bf),
                "xk": torch.stack(xk).to(bf), "xv": torch.stack(xv).to(bf)}
    bf = jnp.bfloat16
    return {"k": jnp.zeros(shape, bf), "v": jnp.zeros(shape, bf),
            "xk": jnp.stack(xk).astype(bf), "xv": jnp.stack(xv).astype(bf)}


def test_whisper_decode_step_matches_reference(model, encoded):
    """Teacher-forced steps from the encoder-built cross cache: each step's
    hidden state and, at the end, the self-attention caches."""
    _, _, jenc = encoded
    cfg, tcfg = rconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    tenc = torch.from_numpy(_np(jenc)).to(torch.bfloat16)
    rcache = cross_cache(model[0], cfg, jenc, ST)
    tcache = cross_cache(model[1], tcfg, tenc, ST)
    np.testing.assert_allclose(tcache["xk"].float().numpy(),
                               _np(rcache["xk"]), **MODEL_TOL)
    step = jax.jit(lambda p, t, c, pos: rwh.whisper_decode_step(p, cfg, t,
                                                                c, pos))
    tokens = _tokens(16)
    for t in range(ST):
        want, rcache = step(model[0], jnp.asarray(tokens[:, t:t + 1]),
                            rcache, jnp.int32(t))
        got, tcache = twh.whisper_decode_step(
            model[1], tcfg, torch.as_tensor(tokens[:, t:t + 1]), tcache,
            torch.tensor(t))
        assert tuple(got.shape) == (B, 1, 64)
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   **MODEL_TOL, err_msg=f"step {t}")
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].float().numpy(),
                                   _np(rcache[name]), **MODEL_TOL)
