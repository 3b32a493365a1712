"""PyTorch port vs JAX reference: the decoder-only families' forward and
prefill (dense qwen2 / qwen1.5 / chatglm3 / gemma2, VLM llava-next, MoE
granite), at their reduced configs.

Each id runs in both packages on the reference's ``init_params``, carried
across bit for bit by ``lm_params_to_torch``, at B = 2, S = 32 and
attention chunk 16 (two query chunks; llava's 8 patches + 24 tokens make
its 32 positions; gemma2's reduced window 8 < S, so its local layer
masks).  Both run in bf16 with float32 islands and round at other places,
so whole models hold within the reference's bf16 tolerance ``atol = rtol
= 5e-2`` (``tests/test_torch_lm.py``'s ``MODEL_TOL``).

MoE: the router's logits are a bf16 product, so two of them often lie an
ulp apart, and the two frameworks' last-ulp differences can route such a
token to another expert.  A token whose k-th and (k+1)-th router logits
lie within ``TIE`` = 1e-2 of each other in any layer (in the port's own
forward) may differ; every other token is held at ``MODEL_TOL``.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import tokens as rtokens
from repro.models import lm as rlm
from repro.models import transformer as rtf

from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_to_torch
from repro_torch.data import tokens as ttokens
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttf

ARCHS = ["qwen2-72b", "chatglm3-6b", "gemma2-27b", "qwen1.5-110b",
         "granite-moe-1b-a400m", "granite-moe-3b-a800m",
         "llava-next-mistral-7b"]
MODEL_TOL = dict(atol=5e-2, rtol=5e-2)
B, S, CHUNK = 2, 32, 16
TIE = 1e-2


def _np(x):
    return np.asarray(x, np.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def router_ties(tcfg, tparams, tbatch, **kw):
    """(B, S) mask of the tokens of ``tbatch["tokens"]`` whose k-th and
    (k+1)-th router logits lie within ``TIE`` in any layer of the port's
    forward (all False for a model without experts)."""
    gaps = []
    route = ttf._route

    def record(x, router_w, k):
        logits = (x @ router_w.to(x.dtype)).float()
        top = torch.sort(logits, dim=-1, descending=True).values
        gaps.append((top[..., k - 1] - top[..., k]).reshape(-1))
        return route(x, router_w, k)

    ttf._route = record
    try:
        with torch.no_grad():
            tlm.forward_hidden(tparams, tcfg, tbatch, remat=False, **kw)
    finally:
        ttf._route = route
    if not gaps:
        return np.zeros(tuple(tbatch["tokens"].shape), bool)
    P = tbatch["patches"].shape[1] if "patches" in tbatch else 0
    tied = (torch.stack(gaps).min(0).values < TIE).numpy()
    return tied.reshape(B, -1)[:, P:]


def ref_case(arch, seed=0):
    """The reference's reduced model and batch of ``arch`` and the same in
    the port."""
    cfg = rconfigs.get_reduced(arch)
    params = rlm.init_params(jax.random.PRNGKey(seed), cfg)
    np_params = jax.tree.map(np.asarray, params)
    batch = rtokens.batch_for_step(cfg, B, S - cfg.n_patches, 3, seed)
    return SimpleNamespace(
        arch=arch, cfg=cfg, tcfg=tconfigs.get_reduced(arch), params=params,
        np_params=np_params, tparams=lm_params_to_torch(np_params),
        batch={k: jnp.asarray(v) for k, v in batch.items()},
        tbatch={k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    case = ref_case(request.param)
    case.hidden = rlm.forward_hidden(case.params, case.cfg, case.batch,
                                     remat=False, chunk=CHUNK)
    case.logits = rlm.prefill(case.params, case.cfg, case.batch,
                              chunk=CHUNK)
    return case


@pytest.fixture
def ties(ref):
    return router_ties(ref.tcfg, ref.tparams, ref.tbatch, chunk=CHUNK)


def test_lm_params_to_torch_is_bit_exact(ref):
    got = dict(_leaves(ref.tparams))
    want = dict(_leaves(ref.np_params))
    assert list(got) == list(want)
    for name, a in want.items():
        t = got[name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).split(".")[-1] == a.dtype.name, name
        assert np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16)), name
    if ref.cfg.n_experts:                       # (L, E, D, F) leaves
        assert got["layers/ewg"].shape == (
            ref.cfg.n_layers, ref.cfg.n_experts, ref.cfg.d_model,
            ref.cfg.expert_d_ff)


@pytest.mark.parametrize("piece", [1 << 30, 1000])
def test_init_params_follows_reference_rules(ref, piece, monkeypatch):
    """The reference's rules, leaves drawn whole or (``INIT_PIECE`` cut
    small) in pieces along their first axis."""
    monkeypatch.setattr(tlm, "INIT_PIECE", piece)
    got = dict(_leaves(tlm.init_params(
        ref.tcfg, generator=torch.Generator().manual_seed(0),
        device="cpu")))
    want = dict(_leaves(ref.np_params))
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16, name
        if np.all(_np(w) == _np(w).flat[0]):      # ones, zeros
            assert torch.equal(g.float(), torch.from_numpy(_np(w))), name
        else:                                     # N(0, 0.02)
            assert abs(float(g.float().std()) - 0.02) < 0.003, name
            assert not torch.equal(g[0], g[1]), name   # no piece repeats


def test_forward_hidden_matches_reference(ref, ties):
    got = tlm.forward_hidden(ref.tparams, ref.tcfg, ref.tbatch, chunk=CHUNK)
    want = _np(ref.hidden)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape == (B, S - ref.cfg.n_patches,
                                              ref.cfg.d_model)
    assert ties.mean() < 0.5
    keep = ~ties
    np.testing.assert_allclose(got.float().numpy()[keep], want[keep],
                               **MODEL_TOL)


def test_prefill_matches_reference(ref):
    got = tlm.prefill(ref.tparams, ref.tcfg, ref.tbatch, chunk=CHUNK)
    want = _np(ref.logits)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (B, 1, ref.cfg.vocab_padded)
    m = want > -1e30
    assert np.array_equal(got.numpy() > -1e30, m)
    np.testing.assert_allclose(got.numpy()[m], want[m], **MODEL_TOL)


def test_remat_leaves_the_forward_bits(ref):
    a = tlm.forward_hidden(ref.tparams, ref.tcfg, ref.tbatch, chunk=CHUNK)
    b = tlm.forward_hidden(ref.tparams, ref.tcfg, ref.tbatch, chunk=CHUNK,
                           remat=False)
    assert torch.equal(a, b)


def test_one_chunk_and_two_chunks_agree(ref):
    """The port's key-narrowed query chunks against one block over all
    positions (the reference's own path at chunk ≥ S)."""
    a = tlm.forward_hidden(ref.tparams, ref.tcfg, ref.tbatch, chunk=CHUNK,
                           remat=False)
    b = tlm.forward_hidden(ref.tparams, ref.tcfg, ref.tbatch, chunk=S,
                           remat=False)
    want = _np(rlm.forward_hidden(ref.params, ref.cfg, ref.batch,
                                  remat=False, chunk=S))
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                               **MODEL_TOL)
    ties = router_ties(ref.tcfg, ref.tparams, ref.tbatch, chunk=S)
    np.testing.assert_allclose(b.float().numpy()[~ties], want[~ties],
                               **MODEL_TOL)
