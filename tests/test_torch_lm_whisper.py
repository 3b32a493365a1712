"""PyTorch port vs JAX reference: Whisper (``whisper-tiny``) as a whole
model through ``models/lm.py``, at its reduced config (2 + 2 layers,
d_model 64, two heads of 32, vocab 256), B = 2, 32 frames and 32 tokens
(``data/tokens.py``'s encoder-decoder batch).

Both packages run the same parameters (``test_torch_whisper.live_whisper``:
the reference's ``init_params`` with live projections and biases), carried
across bit for bit by ``lm_params_to_torch``.  Held as RWKV's whole model
is (``test_torch_lm_rwkv``): hidden states and prefill logits within
``atol = rtol = 5e-2``, at one query chunk and at two; ``train_loss`` and
every gradient leaf; teacher-forced ``decode_step`` from ``init_cache``
(cross-attention K/V zeros, as ``generate`` runs) and from the
encoder-built cross cache against the reference's; the port's decode
against its own forward with that cache at the reference test's
``atol=0.2, rtol=0.05``; greedy ``generate``; the launchers; the specs
and model FLOPs at every cell; ``batch_for_step``'s frames array-equal to
the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import tokens as rtokens
from repro.models import lm as rlm
from repro.models import whisper as rwh

from repro_torch import configs as tconfigs
from repro_torch.data import tokens as ttokens
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttf
from repro_torch.models import whisper as twh

from test_torch_lm_rwkv import (B, MODEL_TOL, S, _caches, _leaves, _np, case,
                                hold_generate, hold_loss_and_grads,
                                hold_specs)
from test_torch_whisper import cross_cache, live_whisper

ARCH = "whisper-tiny"


@pytest.fixture(scope="module")
def ref():
    cfg = rconfigs.get_reduced(ARCH)
    c = case(ARCH, live_whisper()[0], rtokens.batch_for_step(cfg, B, S, 3,
                                                             0))
    c.hidden = rlm.forward_hidden(c.params, cfg, c.batch, remat=False)
    c.logits = rlm.prefill(c.params, cfg, c.batch)
    loss, grads = jax.value_and_grad(
        lambda p: rlm.train_loss(p, cfg, c.batch))(c.params)
    c.loss, c.grads = float(loss), dict(_leaves(jax.tree.map(np.asarray,
                                                             grads)))
    c.step = jax.jit(lambda p, t, cc, pos: rlm.decode_step(p, cfg, t, cc,
                                                           pos))
    return c


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (1, 7), (3, 123)])
def test_batch_for_step_frames_equal_reference(seed, step):
    want = rtokens.batch_for_step(rconfigs.get_reduced(ARCH), 4, 16, step,
                                  seed)
    got = ttokens.batch_for_step(tconfigs.get_reduced(ARCH), 4, 16, step,
                                 seed)
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["frames"].shape == (4, 16, 64)


def test_device_batch_carries_the_frames():
    batch = ttrain.device_batch(tconfigs.get_reduced(ARCH), 2, 16, 0, 0,
                                "cpu")
    assert batch["frames"].dtype == torch.float32
    assert tuple(batch["frames"].shape) == (2, 16, 64)


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
    assert got["pos_enc"].shape == (twh.MAX_POS, 64)
    for name, a in want.items():
        t = got[name]
        assert tuple(t.shape) == a.shape and t.dtype == torch.bfloat16, name
        assert np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16)), name


def test_init_params_follows_reference_rules():
    """Zeros for ``b*`` (``bq``, ``bv``, ``bo``, ``b1``, ``b2``, the norms'
    ``b``), draws for the cross-attention ``xb*`` and both position
    tables, as the reference's name rule gives."""
    cfg = rconfigs.get_reduced(ARCH)
    want = dict(_leaves(jax.tree.map(np.asarray, rlm.init_params(
        jax.random.PRNGKey(0), cfg))))
    got = dict(_leaves(tlm.init_params(
        tconfigs.get_reduced(ARCH), generator=torch.Generator().manual_seed(0),
        device="cpu")))
    assert list(got) == list(want)
    drawn = []
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16, name
        w = _np(w)
        if np.all(w == w.flat[0]):
            assert torch.equal(g.float(), torch.from_numpy(w)), name
        else:
            assert abs(float(g.float().std()) - 0.02) < 0.003, name
            drawn.append(name)
    assert {"dec/xbq", "dec/xbv", "dec/xbo", "pos_enc", "pos_dec"} \
        <= set(drawn)
    assert not {"dec/bq", "enc/bv", "dec/b1"} & set(drawn)


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("chunk", [1024, 16])
def test_forward_hidden_matches_reference(ref, chunk):
    got = tlm.forward_hidden(ref.tparams, ref.tcfg, ref.tbatch, chunk=chunk)
    want = _np(ref.hidden)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape == (B, S, ref.cfg.d_model)
    np.testing.assert_allclose(got.float().numpy(), want, **MODEL_TOL)


def test_prefill_matches_reference(ref):
    got = tlm.prefill(ref.tparams, ref.tcfg, ref.tbatch)
    want = _np(ref.logits)
    assert tuple(got.shape) == want.shape == (B, 1, ref.cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_train_loss_and_grads_match_reference(ref):
    hold_loss_and_grads(ref)


def test_remat_does_not_change_the_forward(ref):
    a = tlm.forward_hidden(ref.tparams, ref.tcfg, ref.tbatch)
    b = tlm.forward_hidden(ref.tparams, ref.tcfg, ref.tbatch, remat=False)
    assert torch.equal(a, b)


# -------------------------------------------------------------- decode
def test_decode_steps_from_init_cache_match_reference(ref):
    """``init_cache``'s zeros for the cross-attention K/V, as
    ``generate`` runs in both packages."""
    steps = 10
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
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL,
                                   err_msg=f"step {t}")
    for name, want in rcache.items():
        np.testing.assert_allclose(tcache[name].float().numpy(), _np(want),
                                   **MODEL_TOL, err_msg=name)


def _encoded(ref, frames=16):
    f = np.random.default_rng(3).standard_normal((B, frames, 64))
    jenc = rwh.whisper_encode(ref.params, ref.cfg,
                              jnp.asarray(f, jnp.bfloat16), remat=False)
    tenc = twh.whisper_encode(ref.tparams, ref.tcfg,
                              torch.from_numpy(f).to(torch.bfloat16),
                              remat=False)
    return jenc, tenc


def test_decode_steps_with_encoder_cache_match_reference(ref):
    jenc, tenc = _encoded(ref)
    steps = 10
    rcache = cross_cache(ref.params, ref.cfg, jenc, steps)
    tcache = cross_cache(ref.tparams, ref.tcfg, tenc, steps)
    tokens = np.random.default_rng(14).integers(0, ref.cfg.vocab,
                                                (B, steps))
    for t in range(steps):
        want, rcache = ref.step(ref.params, jnp.asarray(tokens[:, t:t + 1],
                                                        jnp.int32),
                                rcache, jnp.int32(t))
        got, tcache = tlm.decode_step(ref.tparams, ref.tcfg,
                                      torch.as_tensor(tokens[:, t:t + 1]),
                                      tcache, t)
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL,
                                   err_msg=f"step {t}")


def test_decode_matches_forward(ref):
    """``tests/test_models_lm.py::test_whisper_decode_matches_forward`` on
    the port: 16 frames, 12 tokens, the cross cache built from the
    encoder, every position within ``atol=0.2, rtol=0.05``."""
    _, enc = _encoded(ref)
    St = 12
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        1, ref.cfg.vocab, (B, St)))
    h = twh.whisper_decode_train(ref.tparams, ref.tcfg, tokens, enc,
                                 remat=False)
    want = ttf.logits_for(h, ref.tparams, ref.tcfg)
    cache = cross_cache(ref.tparams, ref.tcfg, enc, St)
    outs = []
    for t in range(St):
        logits, cache = tlm.decode_step(ref.tparams, ref.tcfg,
                                        tokens[:, t:t + 1], cache, t)
        outs.append(logits[:, 0])
    m = want > -1e30
    torch.testing.assert_close(torch.stack(outs, dim=1)[m], want[m],
                               atol=0.2, rtol=0.05)


def test_tensor_pos_equals_int_pos(ref):
    caches = [_caches(ref, 6)[1] for _ in "ab"]
    tokens = np.random.default_rng(13).integers(0, ref.cfg.vocab, (B, 6))
    for t in range(6):
        tok = torch.as_tensor(tokens[:, t:t + 1])
        a, _ = tlm.decode_step(ref.tparams, ref.tcfg, tok, caches[0],
                               torch.tensor(t))
        b, _ = tlm.decode_step(ref.tparams, ref.tcfg, tok, caches[1], t)
        assert torch.equal(a, b)
    for name in caches[0]:
        assert torch.equal(caches[0][name], caches[1][name]), name


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_generate_matches_reference(ref, seed):
    hold_generate(ref, seed)


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


@pytest.mark.parametrize("full", [False, True])
def test_specs_and_model_flops_match_reference(full):
    hold_specs(ARCH, full)
