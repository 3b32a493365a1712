"""PyTorch port vs JAX reference: the decoder-only families' decode path
(dense qwen2 / qwen1.5 / chatglm3 / gemma2, VLM llava-next, MoE granite),
at their reduced configs and B = 2.

The reference's ``decode_step`` (jitted, int32 ``pos``) and the port's
run teacher-forced over the same tokens on the same parameters (the
reference's ``init_params`` carried across): the logits at every step
and every cache tensor at the end within ``MODEL_TOL`` (``atol = rtol =
5e-2``).  20 steps pass gemma2's reduced window of 8, so its local layer
masks the cache.  The port's teacher-forced decode against its own
forward uses the reference's ``atol=0.15, rtol=0.05``
(``tests/test_models_lm.py::test_decode_matches_forward``, llava without
its patch prefix, as there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import lm as rlm

from repro_torch.configs import base as tbase
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttf

from test_torch_lm_dense import ARCHS, MODEL_TOL, ref_case

B = 2


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    case = ref_case(request.param)
    cfg = case.cfg
    case.step = jax.jit(lambda p, t, c, pos: rlm.decode_step(p, cfg, t, c,
                                                             pos))
    return case


def _caches(ref, steps):
    rcache = rlm.init_cache(ref.cfg, rbase.ShapeCell("d", steps, B,
                                                     "decode"))
    tcache = tlm.init_cache(ref.tcfg, tbase.ShapeCell("d", steps, B,
                                                      "decode"),
                            device="cpu")
    return rcache, tcache


def test_decode_steps_and_caches_match_reference(ref):
    steps = 20
    rcache, tcache = _caches(ref, steps)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tcache.items()} == \
        {k: (v.shape, v.dtype.name) for k, v in rcache.items()}
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
        assert tuple(got.shape) == (B, 1, ref.cfg.vocab_padded)
        m = _np(want) > -1e30
        np.testing.assert_allclose(got.numpy()[m], _np(want)[m],
                                   **MODEL_TOL, err_msg=f"step {t}")
    for name, want in rcache.items():
        np.testing.assert_allclose(tcache[name].float().numpy(), _np(want),
                                   **MODEL_TOL, err_msg=name)


def test_tensor_pos_equals_int_pos(ref):
    """``pos`` as a 0-d int64 tensor (what a captured step reads) gives
    the int path's bits, logits and caches."""
    steps = 10
    caches = [_caches(ref, steps)[1] for _ in "ab"]
    tokens = np.random.default_rng(13).integers(0, ref.cfg.vocab,
                                                (B, steps))
    for t in range(steps):
        tok = torch.as_tensor(tokens[:, t:t + 1])
        a, caches[0] = tlm.decode_step(ref.tparams, ref.tcfg, tok,
                                       caches[0], torch.tensor(t))
        b, caches[1] = tlm.decode_step(ref.tparams, ref.tcfg, tok,
                                       caches[1], t)
        assert torch.equal(a, b)
    for name in caches[0]:
        assert torch.equal(caches[0][name], caches[1][name]), name


def test_decode_matches_forward(ref):
    cfg = ref.tcfg.replace(n_patches=0)
    S = 12
    g = torch.Generator().manual_seed(1)
    params = tlm.init_params(cfg, generator=g, device="cpu")
    tokens = torch.randint(1, cfg.vocab, (B, S), generator=g)
    h = tlm.forward_hidden(params, cfg, {"tokens": tokens}, remat=False,
                           chunk=S)
    want = ttf.logits_for(h, params, cfg)
    cache = tlm.init_cache(cfg, tbase.ShapeCell("d", S, B, "decode"),
                           device="cpu")
    outs = []
    for t in range(S):
        logits, cache = tlm.decode_step(params, cfg, tokens[:, t:t + 1],
                                        cache, t)
        outs.append(logits[:, 0])
    m = want > -1e30
    torch.testing.assert_close(torch.stack(outs, dim=1)[m], want[m],
                               atol=0.15, rtol=0.05)
