"""PyTorch port vs JAX reference: the MoE functions and the attention
of the decoder-only families, one function at a time.

Inputs come from numpy seeds and go to both packages in bf16.  Single
functions hold within ``FN_TOL`` (``atol = rtol = 2e-2``,
``tests/test_torch_lm.py``'s); integer results (expert positions, top-k
order) are exact.  The router's logits are a bf16 product widened to
float32, so ties are common: the port's ``top_k`` takes the lower index
first as ``jax.lax.top_k`` does, and a token whose k-th and (k+1)-th
logits lie within ``TIE`` = 1e-2 of each other may still be routed apart
by the frameworks' last-ulp differences, so the MoE outputs are compared
on the other tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as rtf

from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf

FN_TOL = dict(atol=2e-2, rtol=2e-2)
TIE = 1e-2


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)


def _experts(rng, D, E, F):
    return (_bf16(rng, (D, E), D ** -0.5), _bf16(rng, (E, D, F), D ** -0.5),
            _bf16(rng, (E, D, F), D ** -0.5), _bf16(rng, (E, F, D),
                                                    F ** -0.5))


def _untied(x, router, k):
    """Tokens whose k-th and (k+1)-th router logits (the reference's) are
    more than ``TIE`` apart."""
    logits = _np((x @ router).astype(jnp.float32))
    top = -np.sort(-logits, axis=-1)
    return top[..., k - 1] - top[..., k] > TIE


# ---------------------------------------------------------------- routing
def test_positions_in_expert():
    eidx = torch.tensor([0, 1, 0, 0, 1, 2])
    pos = ttf._positions_in_expert(eidx, 3)
    assert pos.tolist() == [0, 0, 1, 2, 1, 0]


@pytest.mark.parametrize("n,E", [(96, 5), (120, 8), (512, 40)])
def test_positions_in_expert_equal_reference(n, E):
    eidx = np.random.default_rng(E).integers(0, E, n)
    got = ttf._positions_in_expert(torch.from_numpy(eidx), E).numpy()
    want = np.asarray(rtf._positions_in_expert(jnp.asarray(eidx), E))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_top_k_tie_order_matches_jax(k):
    """Built ties: equal logits come out lower index first, as from
    ``jax.lax.top_k``."""
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, -1.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, -0.0, 1.0, 1.0, 0.25, 0.25],
                       [5.0, 4.0, 4.0, 4.0, 1.0, 4.0]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(logits), k)
    gv, gi = ttf.top_k(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_top_k_ties_from_bf16_router_logits():
    """Router logits as the model forms them (a bf16 product widened):
    many ties, every index and value equal to ``jax.lax.top_k``'s."""
    rng = np.random.default_rng(0)
    x, router = _bf16(rng, (512, 16)), _bf16(rng, (16, 40), 0.01)
    logits = (x @ router).astype(jnp.float32)
    top = np.sort(_np(logits), axis=-1)
    assert (np.diff(top, axis=-1) == 0).any()      # there are ties
    wv, wi = jax.lax.top_k(logits, 8)
    gv, gi = ttf.top_k(torch.from_numpy(np.array(logits, np.float32)), 8)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


# -------------------------------------------------------------------- MoE
@pytest.mark.parametrize("B,S,k", [(2, 24, 2), (1, 40, 4)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_ffn_matches_reference(B, S, k, act):
    """Ample capacity (the default 1.25: no expert overflows here)."""
    rng = np.random.default_rng(1)
    D, E, F = 32, 8, 16
    x = _bf16(rng, (B, S, D))
    router, wg, wu, wd = _experts(rng, D, E, F)
    eidx = jax.lax.top_k((x @ router).astype(jnp.float32).reshape(-1, E),
                         k)[1]
    pos = np.asarray(rtf._positions_in_expert(eidx.reshape(-1), E))
    assert pos.max() < ttf.expert_capacity(B * S, E, k)
    want = rtf.moe_ffn(x, router, wg, wu, wd, top_k=k, act=act,
                       dispatch="global")
    got = ttf.moe_ffn(_t(x), _t(router), _t(wg), _t(wu), _t(wd), top_k=k,
                      act=act)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, D)
    keep = _untied(x, router, k)
    assert keep.mean() > 0.5
    np.testing.assert_allclose(got.float().numpy()[keep], _np(want)[keep],
                               **FN_TOL)


@pytest.mark.parametrize("cf", [0.25, 0.5])
def test_global_dispatch_drops_as_the_reference(cf):
    """A capacity factor that drops entries (cap 8 or 16, below what the
    busy experts draw): the same entries are dropped, the same output."""
    rng = np.random.default_rng(2)
    B, S, D, E, F, k = 2, 32, 16, 4, 16, 2
    x = _bf16(rng, (B, S, D))
    router, wg, wu, wd = _experts(rng, D, E, F)
    router = router.at[:, 0].add(0.5)                # expert 0 overflows
    want = rtf.moe_ffn(x, router, wg, wu, wd, top_k=k, act="silu",
                       capacity_factor=cf, dispatch="global")
    got = ttf.moe_ffn(_t(x), _t(router), _t(wg), _t(wu), _t(wd), top_k=k,
                      act="silu", capacity_factor=cf)
    eidx = np.asarray(jax.lax.top_k((x @ router).astype(jnp.float32).reshape(
        B * S, E), k)[1])
    pos = np.asarray(rtf._positions_in_expert(jnp.asarray(eidx.reshape(-1)),
                                              E))
    assert (pos >= ttf.expert_capacity(B * S, E, k, cf)).sum() > 8  # drops
    keep = _untied(x, router, k)
    np.testing.assert_allclose(got.float().numpy()[keep], _np(want)[keep],
                               **FN_TOL)


def _mixture(x, router, wg, wu, wd, k, cap):
    """The MoE output by its definition, in float32: each (token, slot) in
    queue order over the whole batch, kept while its expert has had fewer
    than ``cap`` entries, weighted by its gate."""
    x, router, wg, wu, wd = (_np(a) for a in (x, router, wg, wu, wd))
    B, S, D = x.shape
    out = np.zeros_like(x)
    logits = _np(jnp.asarray(x, jnp.bfloat16) @ jnp.asarray(
        router, jnp.bfloat16))
    seen = np.zeros(router.shape[1], int)
    for b in range(B):
        for s in range(S):
            top = np.argsort(-logits[b, s], kind="stable")[:k]
            g = np.exp(logits[b, s, top] - logits[b, s, top].max())
            g /= g.sum()
            for e, w in zip(top, g):
                if seen[e] < cap:
                    h = x[b, s] @ wg[e]
                    h = h / (1 + np.exp(-h)) * (x[b, s] @ wu[e])
                    out[b, s] += w * (h @ wd[e])
                seen[e] += 1
    return out


@pytest.mark.parametrize("cf", [0.25, 0.5])
def test_moe_ffn_drops_by_queue_order(cf):
    """Dropping capacity against the definition: every kept entry's
    expert output, the last slot of an overflowing expert included."""
    rng = np.random.default_rng(3)
    B, S, D, E, F, k = 2, 64, 16, 4, 16, 1
    x = _bf16(rng, (B, S, D))
    router, wg, wu, wd = _experts(rng, D, E, F)
    router = router.at[:, 0].add(1.0)
    got = ttf.moe_ffn(_t(x), _t(router), _t(wg), _t(wu), _t(wd), top_k=k,
                      act="silu", capacity_factor=cf)
    want = _mixture(x, router, wg, wu, wd, k,
                    ttf.expert_capacity(B * S, E, k, cf))
    keep = _untied(x, router, k)
    dropped = (np.abs(want).sum(-1) == 0)
    assert dropped.sum() > 8 and keep.mean() > 0.5
    np.testing.assert_allclose(got.float().numpy()[keep], want[keep],
                               **FN_TOL)
    assert not got.float().numpy()[dropped].any()


@pytest.mark.parametrize("B,S", [(2, 8), (1, 16)])
def test_moe_matches_dense_mixture_when_capacity_ample(B, S):
    """top_k = E with generous capacity: the softmax-weighted mixture of
    all experts (``tests/test_optim_moe.py``'s case, float32)."""
    rng = np.random.default_rng(0)
    D, E, eff = 16, 4, 32
    f = lambda shape, s=1.0: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)) * s
    x, router = f((B, S, D)), f((D, E))
    wg, wu, wd = f((E, D, eff), 0.1), f((E, D, eff), 0.1), f((E, eff, D), 0.1)
    out = ttf.moe_ffn(x, router, wg, wu, wd, top_k=E, act="silu",
                      capacity_factor=4.0)
    xt = x.reshape(-1, D)
    gates = torch.softmax(xt @ router, dim=-1)
    ref = torch.zeros(B * S, D)
    for e in range(E):
        h = torch.nn.functional.silu(xt @ wg[e]) * (xt @ wu[e])
        ref = ref + gates[:, e:e + 1] * (h @ wd[e])
    torch.testing.assert_close(out.reshape(-1, D), ref, atol=2e-4,
                               rtol=2e-3)


@pytest.mark.parametrize("S,cf,cap", [(16, 0.25, 8), (64, 1.0, 16)])
def test_moe_capacity_drops_overflow(S, cf, cap):
    """All tokens to one expert with tiny capacity: finite, and only cap
    tokens get an output (``tests/test_optim_moe.py``'s case)."""
    B, D, E, eff = 1, 8, 4, 8
    x = torch.ones(B, S, D)
    router = torch.zeros(D, E)
    router[:, 0] = 10.0
    w = torch.ones(E, D, eff) * 0.1
    out = ttf.moe_ffn(x, router, w, w, torch.ones(E, eff, D) * 0.1,
                      top_k=1, act="silu", capacity_factor=cf)
    assert torch.isfinite(out).all()
    rows = int((out.reshape(-1, D).abs().sum(-1) > 1e-6).sum())
    assert rows == cap == ttf.expert_capacity(S, E, 1, cf)


def test_moe_gradients_reach_kept_entries_only():
    rng = np.random.default_rng(4)
    B, S, D, E, F = 1, 32, 8, 4, 8
    x = _t(_bf16(rng, (B, S, D))).float().abs().requires_grad_()
    router = torch.zeros(D, E)                   # every token → expert 0
    router[:, 0] = 5.0
    w = [_t(a).float() for a in _experts(rng, D, E, F)[1:]]
    out = ttf.moe_ffn(x, router, *w, top_k=1, act="silu",
                      capacity_factor=0.25)          # cap 8 of 32
    out.sum().backward()
    kept = out.detach().abs().sum(-1)[0] > 0
    assert kept.tolist() == [True] * 8 + [False] * 24   # queue order
    g = x.grad.abs().sum(-1)[0]
    assert (g[kept] > 0).all() and not g[~kept].any()


def test_default_capacity_factor_is_the_reference_s():
    """``MOE_CAPACITY_FACTOR`` (the default every caller of ``moe_ffn``
    and ``expert_capacity`` gets) is the reference's ``moe_ffn`` default."""
    import inspect
    ref = inspect.signature(rtf.moe_ffn).parameters["capacity_factor"]
    assert ttf.MOE_CAPACITY_FACTOR == ref.default
    for p in (inspect.signature(ttf.moe_ffn).parameters["capacity_factor"],
              inspect.signature(ttf.expert_capacity).parameters[
                  "capacity_factor"]):
        assert p.default == ref.default


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("Sq,window,cap,chunk", [
    (32, 0, 50.0, 16),      # gemma2's attention softcap, global, 2 chunks
    (32, 8, 2.0, 16),       # a softcap that bites, local, 2 chunks
    (32, 8, 0.0, 8),        # local, 4 chunks
    (32, 8, 50.0, 16),      # gemma2's local layer: window and softcap
    (16, 0, 2.0, 16),       # one chunk
])
def test_chunked_attention_matches_reference(Sq, window, cap, chunk):
    rng = np.random.default_rng(Sq + window)
    q, k, v = (_bf16(rng, s) for s in ((2, Sq, 4, 16), (2, Sq, 2, 16),
                                       (2, Sq, 2, 16)))
    want = rtf.chunked_attention(q, k, v, window=window, attn_softcap=cap,
                                 chunk=chunk)
    got = ttf.chunked_attention(_t(q), _t(k), _t(v), window=window,
                                attn_softcap=cap, chunk=chunk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), **FN_TOL)


@pytest.mark.parametrize("local", [False, True])
def test_local_flag_is_a_window_per_layer(local):
    """The reference's traced ``local_flag`` (gemma2's alternation) is the
    port's static window: a global layer sees every earlier key."""
    rng = np.random.default_rng(5)
    q, k, v = (_bf16(rng, s) for s in ((1, 32, 4, 16), (1, 32, 2, 16),
                                       (1, 32, 2, 16)))
    want = rtf.chunked_attention(q, k, v, window=8, attn_softcap=50.0,
                                 local_flag=jnp.asarray(local), chunk=16)
    got = ttf.chunked_attention(_t(q), _t(k), _t(v), window=8 if local else 0,
                                attn_softcap=50.0, chunk=16)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **FN_TOL)


@pytest.mark.parametrize("pos,window,cap", [(0, 0, 0.0), (13, 0, 50.0),
                                            (13, 4, 50.0), (19, 8, 2.0),
                                            (19, 0, 0.0)])
def test_decode_attn_matches_reference(pos, window, cap):
    """One query at ``pos`` against a 20-slot cache (slots past ``pos``
    hold stale values, which must not count)."""
    rng = np.random.default_rng(pos)
    q, ck, cv = (_bf16(rng, s) for s in ((2, 1, 4, 16), (2, 20, 2, 16),
                                         (2, 20, 2, 16)))
    want = rtf._attn_block(q, ck, cv, causal=True, window=window,
                           attn_softcap=cap, local_flag=None,
                           q_offset=jnp.int32(pos))
    got = ttf.decode_attn(_t(q), _t(ck), _t(cv), torch.tensor(pos),
                          window=window, attn_softcap=cap)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **FN_TOL)


def test_gelu_follows_jax_in_bf16():
    """Op by op with the constants rounded to bf16: the reference's bits
    (``F.gelu(approximate="tanh")`` differs in ~43% of them)."""
    x = np.random.default_rng(6).standard_normal(65536).astype(np.float32)
    want = _np(jax.nn.gelu(jnp.asarray(x * 3, jnp.bfloat16)))
    got = tcommon.gelu_tanh(_t(x * 3)).float().numpy()
    np.testing.assert_array_equal(got, want)
    one_shot = torch.nn.functional.gelu(_t(x * 3), approximate="tanh")
    assert (one_shot.float().numpy() != want).mean() > 0.2


def test_gemma_embedding_scale_is_rounded_first():
    """sqrt(float32(4608)) = 67.88 rounds to 68.0 in bf16 before the
    product, as in the reference."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm as tlm
    cfg = get_reduced("gemma2-27b").replace(d_model=4608)
    embed = torch.ones(4, 4608, dtype=torch.bfloat16) * 0.5
    x = tlm._embed_tokens({"embed": embed}, cfg, torch.tensor([[1]]))
    assert float(x[0, 0, 0]) == 34.0
