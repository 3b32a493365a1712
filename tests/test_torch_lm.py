"""PyTorch port vs JAX reference: the LM side's Hymba serving path.

The reduced Hymba (3 layers, d_model 64, window 8) runs in both packages
on the same weights: the reference's ``init_params`` with ``bc_w`` and
``d_skip`` redrawn from numpy at N(0, 0.02) (its init rule zeroes both, by
their names, which would leave the scan's dBx at 0), carried across by
``lm_params_to_torch`` bit for bit.  Both run in bf16 with float32
islands, and bf16 rounds at other places in the two frameworks, so the
comparisons hold within the reference's own bf16 backend-agreement
tolerance ``atol = rtol = 5e-2`` (``tests/test_selective_scan.py::
test_mamba_branch_backends_agree``), single functions within
``atol = rtol = 2e-2``.  The port's own decode-vs-forward consistency
uses the reference's tolerances (``atol=0.15 / 0.2, rtol=0.05``).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.launch import serve as rserve
from repro.models import common as rcommon
from repro.models import lm as rlm
from repro.models import ssm as rssm
from repro.models import transformer as rtf

from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_params_to_torch
from repro_torch.kernels import selective_scan as tscan
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf

ARCH = "hymba-1.5b"
MODEL_TOL = dict(atol=5e-2, rtol=5e-2)
FN_TOL = dict(atol=2e-2, rtol=2e-2)
B, S, CHUNK = 2, 32, 16          # S > CHUNK: two query chunks per layer


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.bfloat16):
    """numpy → torch, through float32 (bf16 values are exact in it)."""
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _valid(logits):
    """Mask of the real vocab (the padding is NEG_INF in both)."""
    return _np(logits) > -1e30


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


@pytest.fixture(scope="module")
def ref():
    """Reduced Hymba in both packages, and the reference's results."""
    cfg = rconfigs.get_reduced(ARCH)
    params = _ref_params()
    np_params = jax.tree.map(np.asarray, params)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (B, S))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    hidden = {}
    for backend in ("xla", "pallas"):
        try:
            rcommon.reset_perf_options()
            rcommon.set_perf_options(ssm_backend=backend)
            hidden[backend] = rlm.forward_hidden(params, cfg, batch,
                                                 remat=False, chunk=CHUNK)
        finally:
            rcommon.reset_perf_options()
    return SimpleNamespace(
        cfg=cfg, tcfg=tconfigs.get_reduced(ARCH), params=params,
        np_params=np_params, tparams=lm_params_to_torch(np_params),
        tokens=tokens, hidden=hidden,
        logits={k: rtf.logits_for(h[:, -1:], params, cfg)
                for k, h in hidden.items()})


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
def test_config_tables_equal_reference(which):
    r, t = getattr(rconfigs, which)(ARCH), getattr(tconfigs, which)(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    for prop in ("q_dim", "kv_dim", "vocab_padded"):
        assert getattr(t, prop) == getattr(r, prop)
    assert tbase.applicable_shapes(t) == rbase.applicable_shapes(r)
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()}


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "whisper-tiny"])
def test_rwkv_and_whisper_configs_equal_reference(arch):
    """The last two families of the JAX package: both tables equal the
    reference's; an unknown id still raises ``KeyError``."""
    for which in ("get_config", "get_reduced"):
        r, t = getattr(rconfigs, which)(arch), getattr(tconfigs, which)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert tbase.applicable_shapes(t) == rbase.applicable_shapes(r)
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


# ----------------------------------------------------------------- params
def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def test_init_params_follows_reference_rules(ref):
    want = dict(_leaves(jax.tree.map(np.asarray, rlm.init_params(
        jax.random.PRNGKey(0), ref.cfg))))
    got = dict(_leaves(tlm.init_params(
        ref.tcfg, generator=torch.Generator().manual_seed(0),
        device="cpu")))
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == w.dtype.name, name
        if name.endswith("a_log"):                # float32 log(1..N)
            assert g.dtype == torch.float32
            assert torch.equal(g, torch.from_numpy(np.array(w))), name
        elif np.all(_np(w) == _np(w).flat[0]):    # constant rule leaves
            assert torch.equal(g.float(), _t(w, torch.float32)), name
        else:                                     # N(0, 0.02) matrices
            assert abs(float(g.float().std()) - 0.02) < 0.002, name
            assert abs(float(g.float().mean())) < 0.002, name


def test_lm_params_to_torch_is_bit_exact(ref):
    for name, a in _leaves(ref.np_params):
        t = dict(_leaves(ref.tparams))[name]
        assert str(t.dtype).split(".")[-1] == a.dtype.name, name
        if a.dtype.name == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), name
        else:
            assert np.array_equal(t.numpy(), a), name


# -------------------------------------------------------------- functions
def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 7, 4, 16)) * 3, jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal(16), jnp.bfloat16)
    for plus_one in (False, True):
        want = rcommon.rms_norm(x, w, plus_one=plus_one)
        got = tcommon.rms_norm(_t(x), _t(w), plus_one=plus_one)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), _np(want), **FN_TOL)
    pos = np.arange(5, 12)[None]
    rc, rs, rrot = rcommon.rope_tables(jnp.asarray(pos), 16)
    tc, ts, trot = tcommon.rope_tables(torch.as_tensor(pos), 16)
    assert trot == rrot and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), _np(rc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), _np(rs), atol=1e-6)
    got = tcommon.apply_rope(_t(x), tc, ts, trot)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               _np(rcommon.apply_rope(x, rc, rs, rrot)),
                               **FN_TOL)


@pytest.mark.parametrize("Sq,window,chunk", [
    (16, 8, 16),          # SWA, one chunk
    (32, 8, 8),           # SWA, Sq > chunk
    (32, 0, 16),          # global, Sq > chunk
])
def test_chunked_attention_matches_reference(Sq, window, chunk):
    rng = np.random.default_rng(Sq + window)
    q, k, v = (jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
               for s in ((2, Sq, 4, 16), (2, Sq, 2, 16), (2, Sq, 2, 16)))
    want = rtf.chunked_attention(q, k, v, window=window, chunk=chunk)
    got = ttf.chunked_attention(_t(q), _t(k), _t(v), window=window,
                                chunk=chunk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), **FN_TOL)


def _live_mamba_layer(cfg, rng):
    """One mamba layer whose branch carries an O(1) signal (at the
    model's N(0, 0.02) init it carries almost none of its input)."""
    D, N = cfg.d_model, cfg.ssm_state
    Di = cfg.ssm_expand * D
    scales = {"in_proj": ((D, 2 * Di), D ** -0.5), "conv_w": ((4, Di), 0.5),
              "dt_a": ((Di, 64), Di ** -0.5), "dt_proj": ((64, Di), 0.125),
              "dt_b": ((Di,), 0.5), "bc_w": ((Di, 2 * N), Di ** -0.5),
              "d_skip": ((Di,), 1.0), "out_proj": ((Di, D), Di ** -0.5)}
    lp = {k: jnp.asarray(rng.standard_normal(s) * sc, jnp.bfloat16)
          for k, (s, sc) in scales.items()}
    lp["a_log"] = jnp.log(jnp.broadcast_to(
        jnp.arange(1, N + 1, dtype=jnp.float32), (Di, N)))
    return lp, lm_params_to_torch(jax.tree.map(np.asarray, lp))


def test_mamba_branch_prefill_and_decode_match_reference(ref):
    rng = np.random.default_rng(3)
    lp, tlp = _live_mamba_layer(ref.cfg, rng)
    D, Di, N = ref.cfg.d_model, 2 * ref.cfg.d_model, ref.cfg.ssm_state
    x = jnp.asarray(rng.standard_normal((2, 24, D)), jnp.bfloat16)
    want = rssm.mamba_branch(x, lp, ref.cfg)
    got = tssm.mamba_branch(_t(x), tlp, ref.tcfg)
    assert np.abs(_np(want)).max() > 0.5          # the branch is live
    np.testing.assert_allclose(got.float().numpy(), _np(want), **FN_TOL)

    conv = jnp.asarray(rng.standard_normal((2, 3, Di)), jnp.bfloat16)
    ssm = jnp.asarray(rng.standard_normal((2, Di, N)), jnp.float32)
    y, nconv, nssm = rssm.mamba_branch(x[:, :1], lp, ref.cfg,
                                       conv_state=conv, ssm_state=ssm)
    ty, tconv, tssm_ = tssm.mamba_branch(
        _t(x[:, :1]), tlp, ref.tcfg, conv_state=_t(conv),
        ssm_state=_t(ssm, torch.float32))
    assert tconv.dtype == torch.bfloat16 and tssm_.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(), _np(y), **FN_TOL)
    assert np.array_equal(tconv.float().numpy(), _np(nconv))
    np.testing.assert_allclose(tssm_.numpy(), _np(nssm), **FN_TOL)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_forward_hidden_matches_reference(ref, backend):
    got = tlm.forward_hidden(ref.tparams, ref.tcfg,
                             {"tokens": torch.as_tensor(ref.tokens)},
                             chunk=CHUNK)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, 64)
    np.testing.assert_allclose(got.float().numpy(), _np(ref.hidden[backend]),
                               **MODEL_TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_prefill_matches_reference(ref, backend):
    before = tscan.launch_count()
    got = tlm.prefill(ref.tparams, ref.tcfg,
                      {"tokens": torch.as_tensor(ref.tokens)}, chunk=CHUNK)
    assert tscan.launch_count() == before       # CPU: the plain scan
    want = ref.logits[backend]
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (B, 1, ref.cfg.vocab_padded)
    assert np.array_equal(_valid(got), _valid(want))
    m = _valid(want)
    np.testing.assert_allclose(got.numpy()[m], _np(want)[m], **MODEL_TOL)


def test_reference_prefill_is_forward_then_logits(ref):
    """The reference's ``prefill`` is ``logits_for`` of the last hidden
    state, which the fixture computes from ``forward_hidden``."""
    cfg = ref.cfg.replace(n_layers=2)           # a cheaper compile
    params = rlm.init_params(jax.random.PRNGKey(4), cfg)
    batch = {"tokens": jnp.asarray(ref.tokens[:, :8], jnp.int32)}
    want = rtf.logits_for(rlm.forward_hidden(params, cfg, batch,
                                             remat=False)[:, -1:],
                          params, cfg)
    np.testing.assert_array_equal(_np(rlm.prefill(params, cfg, batch)),
                                  _np(want))
    tparams = lm_params_to_torch(jax.tree.map(np.asarray, params))
    got = tlm.prefill(tparams, tconfigs.get_reduced(ARCH).replace(
        n_layers=2), {"tokens": torch.as_tensor(ref.tokens[:, :8])})
    m = _valid(want)
    np.testing.assert_allclose(got.numpy()[m], _np(want)[m], **MODEL_TOL)


def test_decode_steps_and_caches_match_reference(ref):
    """20 teacher-forced decode steps (past the reduced window of 8): the
    logits at every step, and every cache tensor at the end."""
    steps = 20
    cell = rbase.ShapeCell("d", steps, B, "decode")
    rcache = rlm.init_cache(ref.cfg, cell)
    tcache = tlm.init_cache(ref.tcfg, tbase.ShapeCell("d", steps, B,
                                                      "decode"),
                            device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tcache.items()} == \
        {k: (v.shape, v.dtype.name) for k, v in rcache.items()}
    step = jax.jit(lambda p, t, c, pos: rlm.decode_step(p, ref.cfg, t, c,
                                                        pos))
    tokens = np.random.default_rng(12).integers(0, ref.cfg.vocab,
                                                (B, steps))
    for t in range(steps):
        want, rcache = step(ref.params, jnp.asarray(tokens[:, t:t + 1],
                                                    jnp.int32),
                            rcache, jnp.int32(t))
        got, tcache = tlm.decode_step(ref.tparams, ref.tcfg,
                                      torch.as_tensor(tokens[:, t:t + 1]),
                                      tcache, t)
        m = _valid(want)
        np.testing.assert_allclose(got.numpy()[m], _np(want)[m],
                                   **MODEL_TOL)
    for name, want in rcache.items():
        np.testing.assert_allclose(tcache[name].float().numpy(), _np(want),
                                   **MODEL_TOL, err_msg=name)


def test_decode_with_a_tensor_pos(ref):
    """``pos`` as a 0-d int64 tensor (what a captured decode step reads):
    bit-equal to the int path, logits and caches, at every step; and within
    the reference's tolerance of its ``decode_step`` (int32 ``pos``, as it
    jits it) over 20 steps, past the reduced window of 8, so the ring's
    write slot wraps twice."""
    steps = 20
    assert ref.tcfg.sliding_window < steps
    cell = tbase.ShapeCell("d", steps, B, "decode")
    caches = [tlm.init_cache(ref.tcfg, cell, device="cpu") for _ in "ab"]
    rcache = rlm.init_cache(ref.cfg, rbase.ShapeCell("d", steps, B,
                                                     "decode"))
    step = jax.jit(lambda p, t, c, pos: rlm.decode_step(p, ref.cfg, t, c,
                                                        pos))
    tokens = np.random.default_rng(13).integers(0, ref.cfg.vocab,
                                                (B, steps))
    for t in range(steps):
        tok = torch.as_tensor(tokens[:, t:t + 1])
        got, caches[0] = tlm.decode_step(ref.tparams, ref.tcfg, tok,
                                         caches[0], torch.tensor(t))
        same, caches[1] = tlm.decode_step(ref.tparams, ref.tcfg, tok,
                                          caches[1], t)
        assert torch.equal(got, same)
        for name in caches[0]:
            assert torch.equal(caches[0][name], caches[1][name]), name
        want, rcache = step(ref.params, jnp.asarray(tokens[:, t:t + 1],
                                                    jnp.int32),
                            rcache, jnp.int32(t))
        m = _valid(want)
        np.testing.assert_allclose(got.numpy()[m], _np(want)[m],
                                   **MODEL_TOL)
    for name, want in rcache.items():
        np.testing.assert_allclose(caches[0][name].float().numpy(),
                                   _np(want), **MODEL_TOL, err_msg=name)


TIE = 1e-2      # top-two logits this close: either greedy pick is right


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_generate_matches_reference(ref, seed):
    """Greedy tokens equal the reference's ``generate`` up to each row's
    first near-tie, a step where the reference's top two logits lie within
    ``TIE`` (bf16 logits ~0.5–1 have ulps of 0.002–0.004 and round at
    other places in the two frameworks, so either order is right there;
    seed 0 has one at a one-ulp margin).  Teacher-forced along the
    reference's tokens, the port's pick at every generated step is the
    reference's or within ``TIE`` of it in the reference's logits."""
    P, total = 6, 14
    prompt = np.random.default_rng(seed).integers(0, ref.cfg.vocab, (B, P))
    want = np.array(rserve.generate(ref.cfg, ref.params,
                                    jnp.asarray(prompt, jnp.int32),
                                    total, total - P))
    got = tserve.generate(ref.tcfg, ref.tparams, prompt, total, total - P,
                          device="cpu").numpy()
    assert got.shape == want.shape == (B, total)
    step = jax.jit(lambda p, t, c, pos: rlm.decode_step(p, ref.cfg, t, c,
                                                        pos))
    rcache = rlm.init_cache(ref.cfg, rbase.ShapeCell("d", total, B,
                                                     "decode"))
    tcache = tlm.init_cache(ref.tcfg, tbase.ShapeCell("d", total, B,
                                                      "decode"),
                            device="cpu")
    agree_upto = np.full(B, total)
    rows = np.arange(B)
    for t in range(total - 1):
        rl, rcache = step(ref.params, jnp.asarray(want[:, t:t + 1]), rcache,
                          jnp.int32(t))
        tl, tcache = tlm.decode_step(ref.tparams, ref.tcfg,
                                     torch.as_tensor(want[:, t:t + 1]),
                                     tcache, t)
        if t + 1 < P:
            continue
        rl = _np(rl)[:, 0]
        pick = tl[:, 0].argmax(-1).numpy()
        nxt = want[:, t + 1]
        assert np.all((pick == nxt) | (rl[rows, nxt] - rl[rows, pick] <= TIE))
        top2 = np.sort(rl, axis=-1)[:, -2:]
        tie = top2[:, 1] - top2[:, 0] <= TIE
        agree_upto = np.where(tie, np.minimum(agree_upto, t + 1), agree_upto)
    for b in rows:
        np.testing.assert_array_equal(got[b, :agree_upto[b]],
                                      want[b, :agree_upto[b]])
    assert agree_upto.min() > P


def test_generate_refuses_graphs_off_the_card(ref):
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        tserve.generate(ref.tcfg, ref.tparams, np.zeros((1, 2), np.int64),
                        4, 2, device="cpu", graphs=True)


def test_temperature_generate_is_seeded(ref):
    prompt = np.random.default_rng(5).integers(0, ref.cfg.vocab, (2, 4))
    runs = [tserve.generate(ref.tcfg, ref.tparams, prompt, 10, 6,
                            temperature=1.0, seed=s, device="cpu")
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0][:, :4], torch.as_tensor(prompt))
    assert int(runs[0].max()) < ref.cfg.vocab     # padding never sampled
    assert not torch.equal(runs[0], runs[2])


# -------------------------------------------- the port's own consistency
def _decode_vs_forward(cfg, params, tokens):
    Bt, St = tokens.shape
    h = tlm.forward_hidden(params, cfg, {"tokens": tokens}, chunk=St)
    want = ttf.logits_for(h, params, cfg)
    cache = tlm.init_cache(cfg, tbase.ShapeCell("d", St, Bt, "decode"),
                           device="cpu")
    outs = []
    for t in range(St):
        logits, cache = tlm.decode_step(params, cfg, tokens[:, t:t + 1],
                                        cache, t)
        outs.append(logits[:, 0])
    m = want > -1e30
    return torch.stack(outs, dim=1)[m], want[m]


@pytest.mark.parametrize("S,Bt,atol", [
    (12, 2, 0.15),   # tests/test_models_lm.py::test_decode_matches_forward
    (20, 1, 0.2),    # ::test_hymba_ring_buffer_beyond_window (window 8)
])
def test_decode_matches_forward(ref, S, Bt, atol):
    g = torch.Generator().manual_seed(S)
    params = tlm.init_params(ref.tcfg, generator=g, device="cpu")
    for stack in ("layers", "glayers"):      # a live scan, as in ``ref``
        for name in ("bc_w", "d_skip"):
            params[stack][name] = (torch.randn(
                params[stack][name].shape, generator=g) * 0.02).to(
                    torch.bfloat16)
    tokens = torch.randint(1, ref.cfg.vocab, (Bt, S), generator=g)
    got, want = _decode_vs_forward(ref.tcfg, params, tokens)
    torch.testing.assert_close(got, want, atol=atol, rtol=0.05)
