"""PyTorch port vs JAX reference: greedy ``generate`` of the decoder-only
families (dense qwen2 / qwen1.5 / chatglm3 / gemma2, VLM llava-next, MoE
granite), reduced, B = 2: the tokens equal the reference's
``launch/serve.py::generate`` up to each row's first near-tie (top-two
logits within ``TIE`` = 1e-2), as ``tests/test_torch_lm.py`` holds
Hymba's, and teacher-forced along the reference's tokens the port's pick
at every generated step is the reference's or within ``TIE`` of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as rserve
from repro.models import lm as rlm

from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm

from test_torch_lm_dense import ARCHS, TIE, ref_case
from test_torch_lm_dense_decode import B, _caches, _np


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    case = ref_case(request.param)
    cfg = case.cfg
    case.step = jax.jit(lambda p, t, c, pos: rlm.decode_step(p, cfg, t, c,
                                                             pos))
    return case


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_generate_matches_reference(ref, seed):
    """Greedy tokens equal the reference's ``generate`` up to each row's
    first near-tie; teacher-forced along the reference's tokens, the
    port's pick at every generated step is the reference's or within
    ``TIE`` of it in the reference's logits."""
    P, total = 6, 14
    prompt = np.random.default_rng(seed).integers(0, ref.cfg.vocab, (B, P))
    want = np.array(rserve.generate(ref.cfg, ref.params,
                                    jnp.asarray(prompt, jnp.int32),
                                    total, total - P))
    got = tserve.generate(ref.tcfg, ref.tparams, prompt, total, total - P,
                          device="cpu").numpy()
    assert got.shape == want.shape == (B, total)
    rcache, tcache = _caches(ref, total)
    agree_upto = np.full(B, total)
    rows = np.arange(B)
    for t in range(total - 1):
        rl, rcache = ref.step(ref.params, jnp.asarray(want[:, t:t + 1]),
                              rcache, jnp.int32(t))
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
    # at the N(0, 0.02) init a reduced model's top logits lie ~0.01
    # apart, so a row's first generated step can be a near-tie already
    assert agree_upto.max() > P
