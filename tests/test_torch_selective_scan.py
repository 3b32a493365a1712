"""PyTorch port vs JAX reference: the selective scan (Mamba recurrence).

On CPU tensors the port's ``selective_scan`` runs its plain version
(``selective_scan_plain``, a loop over time).  It is held against the
reference's Pallas kernel in interpret mode at two shapes (one with S and
Di that need padding in the reference) and against the reference's
associative-scan oracle ``selective_scan_ref`` over a seeded sweep of S, N
and Di, at the reference test's own tolerance ``atol = rtol = 2e-4``.
The impulse case checks that state carries across the whole sequence.

Gradients: autograd through the plain version and the plain backward
(``selective_scan_backward_plain``, the function the card's backward kernel
is held against) each within ``1e-5 × max |g|`` of ``jax.grad`` of the
reference's ``selective_scan_ref``, per operand.

Chunk states (what the training forward keeps for the backward, every
``CHUNK`` steps): ``selective_scan_chunk_states_plain`` equals
``selective_scan_states_plain`` at the chunk ends, and the plain backward
from them (``selective_scan_backward_from_states_plain``, the card's
backward kernel's plain version) equals ``selective_scan_backward_plain``
on every hidden state bit for bit and ``jax.grad`` within ``1e-5 × max
|g|``, at S ∈ {1, T − 1, T, T + 1, 3T + 5} with ragged Di; the wrapper
``selective_scan_backward`` on CPU tensors runs it and launches nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import selective_scan as r_scan
from repro.kernels.selective_scan import selective_scan_ref as r_scan_ref
from _propcheck import integers, propcases, sampled_from

from repro_torch.kernels.selective_scan import (
    CHUNK, launch_count, selective_scan, selective_scan_backward,
    selective_scan_backward_from_states_plain, selective_scan_backward_plain,
    selective_scan_chunk_states_plain, selective_scan_plain,
    selective_scan_states_plain)

TOL = dict(atol=2e-4, rtol=2e-4)        # tests/test_selective_scan.py


def _mk(rng, B, S, N, Di):
    """Decays in (0.2, 0.99), bounded inputs — the regime mamba produces
    (the reference test's draws), as float32 numpy arrays."""
    dA = rng.uniform(0.2, 0.99, (B, S, N, Di)).astype(np.float32)
    dBx = (rng.standard_normal((B, S, N, Di)) * 0.1).astype(np.float32)
    C = rng.standard_normal((B, S, N)).astype(np.float32)
    return dA, dBx, C


def _port(dA, dBx, C):
    return selective_scan(*(torch.from_numpy(a) for a in (dA, dBx, C)))


@pytest.mark.parametrize("B,S,N,Di,chunk", [
    (2, 64, 4, 128, 16),
    (1, 33, 2, 130, 16),           # padding on both S and Di in the reference
])
def test_matches_pallas_kernel_interpret(B, S, N, Di, chunk):
    dA, dBx, C = _mk(np.random.default_rng(0), B, S, N, Di)
    want = np.asarray(r_scan(jnp.asarray(dA), jnp.asarray(dBx),
                             jnp.asarray(C), chunk=chunk, tile=128))
    got = _port(dA, dBx, C)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, Di)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", propcases(
    10, S=integers(4, 70), N=sampled_from([2, 4, 8]),
    Di=sampled_from([32, 130]), seed=integers(0, 99)), ids=str)
def test_matches_reference_oracle(case):
    dA, dBx, C = _mk(np.random.default_rng(case.seed), 1, case.S, case.N,
                     case.Di)
    want = np.asarray(r_scan_ref(jnp.asarray(dA), jnp.asarray(dBx),
                                 jnp.asarray(C)))
    np.testing.assert_allclose(_port(dA, dBx, C).numpy(), want, **TOL)


def test_state_carries_across_chunks():
    """A single impulse at t=0 must still reach the LAST step (the
    reference runs it in chunks of 16; the port has no chunks on the CPU,
    the kernel has 8-step ones on the card)."""
    B, S, N, Di = 1, 64, 2, 128
    dA = np.full((B, S, N, Di), 0.95, np.float32)
    dBx = np.zeros((B, S, N, Di), np.float32)
    dBx[:, 0] = 1.0
    C = np.ones((B, S, N), np.float32)
    y = _port(dA, dBx, C).numpy()
    expect_last = 2 * 0.95 ** (S - 1)          # N=2 summed
    np.testing.assert_allclose(y[0, -1, 0], expect_last, rtol=1e-3)
    want = np.asarray(r_scan(jnp.asarray(dA), jnp.asarray(dBx),
                             jnp.asarray(C), chunk=16))
    np.testing.assert_allclose(y, want, **TOL)


def test_casts_operands_to_float32():
    """Like the reference wrapper, any float dtype is scanned in float32."""
    dA, dBx, C = _mk(np.random.default_rng(4), 2, 9, 4, 24)
    args = [torch.from_numpy(a) for a in (dA, dBx, C)]
    got = selective_scan(args[0].double(), args[1].to(torch.bfloat16),
                         args[2].double())
    want = selective_scan_plain(args[0], args[1].to(torch.bfloat16).float(),
                                args[2])
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_rejects_wrong_ranks_shapes_and_devices():
    dA, dBx, C = (torch.from_numpy(a) for a in
                  _mk(np.random.default_rng(1), 1, 5, 2, 8))
    with pytest.raises(ValueError, match=r"\(B, S, N, Di\)"):
        selective_scan(dA[0], dBx[0], C[0])
    with pytest.raises(ValueError, match=r"\(B, S, N, Di\)"):
        selective_scan(dA, dBx[:, :4], C)
    with pytest.raises(ValueError, match=r"\(B, S, N, Di\)"):
        selective_scan(dA, dBx, C[..., :1])
    with pytest.raises(ValueError, match="cpu or cuda"):
        selective_scan(dA.to("meta"), dBx.to("meta"), C.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        selective_scan(dA, dBx, C.to("meta"))


def test_cpu_tensors_take_the_plain_version():
    """No launch is counted on the CPU."""
    dA, dBx, C = (torch.from_numpy(a) for a in
                  _mk(np.random.default_rng(2), 2, 17, 4, 40))
    before = launch_count()
    want = selective_scan_plain(dA, dBx, C)
    assert torch.equal(selective_scan(dA, dBx, C), want)
    assert launch_count() == before


GRAD_SHAPES = [(1, 1, 2, 32), (2, 33, 4, 130), (1, 70, 8, 24),
               (2, 17, 2, 16)]
GRAD_RTOL = 1e-5                        # × max |g| of each operand


def _ref_grads(dA, dBx, C, gy):
    """jax.grad of Σ y ⊙ gy through the reference's associative scan."""
    f = lambda a, x, c: jnp.sum(r_scan_ref(a, x, c) * gy)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(C))]


def _close_to(got, want, what):
    for name, g, w in zip(("dA", "dBx", "C"), got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        top = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_RTOL * top, (what, name, err, top)


@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=str)
def test_plain_autograd_matches_reference_grad(shape):
    B, S, N, Di = shape
    rng = np.random.default_rng(sum(shape))
    dA, dBx, C = _mk(rng, B, S, N, Di)
    gy = rng.standard_normal((B, S, Di)).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (dA, dBx, C)]
    y = selective_scan(*ts)
    got = torch.autograd.grad(y, ts, torch.from_numpy(gy))
    _close_to(got, _ref_grads(dA, dBx, C, gy), "autograd")


@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=str)
def test_plain_backward_matches_reference_grad_and_autograd(shape):
    B, S, N, Di = shape
    rng = np.random.default_rng(1 + sum(shape))
    dA, dBx, C = _mk(rng, B, S, N, Di)
    gy = rng.standard_normal((B, S, Di)).astype(np.float32)
    tA, tX, tC, tg = (torch.from_numpy(a) for a in (dA, dBx, C, gy))
    h = selective_scan_states_plain(tA, tX)
    assert torch.equal((h * tC[..., None]).sum(2),
                       selective_scan_plain(tA, tX, tC))
    got = selective_scan_backward_plain(tA, tC, h, tg)
    assert [tuple(g.shape) for g in got] == [(B, S, N, Di), (B, S, N, Di),
                                             (B, S, N)]
    _close_to(got, _ref_grads(dA, dBx, C, gy), "plain backward")
    ts = [t.clone().requires_grad_() for t in (tA, tX, tC)]
    auto = torch.autograd.grad(selective_scan_plain(*ts), ts, tg)
    _close_to(got, [a.numpy() for a in auto], "plain backward vs autograd")


def test_backward_impulse_reaches_step_zero():
    """A cotangent at the last step only must reach dBx at step 0 through
    S − 1 decays."""
    B, S, N, Di = 1, 64, 2, 16
    dA = torch.full((B, S, N, Di), 0.95)
    C = torch.ones((B, S, N))
    gy = torch.zeros((B, S, Di))
    gy[:, -1] = 1.0
    h = selective_scan_states_plain(dA, torch.ones_like(dA))
    _, g_dBx, _ = selective_scan_backward_plain(dA, C, h, gy)
    torch.testing.assert_close(g_dBx[0, 0], torch.full((N, Di),
                                                       0.95 ** (S - 1)),
                               rtol=1e-5, atol=0)


T = CHUNK
# S around the chunk length; Di ragged against the kernel's 32-column slices
CHUNK_SHAPES = [(2, 1, 4, 40), (1, T - 1, 4, 130), (2, T, 2, 40),
                (1, T + 1, 4, 130), (2, 3 * T + 5, 4, 40)]


def _chunk_case(shape, seed):
    rng = np.random.default_rng(seed)
    dA, dBx, C = _mk(rng, *shape)
    gy = rng.standard_normal(shape[:2] + shape[3:]).astype(np.float32)
    return (dA, dBx, C, gy), [torch.from_numpy(a) for a in (dA, dBx, C, gy)]


@pytest.mark.parametrize("shape", CHUNK_SHAPES, ids=str)
def test_chunk_states_are_the_states_at_chunk_ends(shape):
    _, (tA, tX, _, _) = _chunk_case(shape, 11)
    S = shape[1]
    states = selective_scan_chunk_states_plain(tA, tX, T)
    assert tuple(states.shape) == (shape[0], -(-S // T)) + shape[2:]
    ends = [min((k + 1) * T, S) - 1 for k in range(states.shape[1])]
    assert torch.equal(states, selective_scan_states_plain(tA, tX)[:, ends])


@pytest.mark.parametrize("shape", CHUNK_SHAPES, ids=str)
def test_backward_from_states_matches_reference_grad(shape):
    (dA, dBx, C, gy), (tA, tX, tC, tg) = _chunk_case(shape, 12)
    states = selective_scan_chunk_states_plain(tA, tX, T)
    got = selective_scan_backward_from_states_plain(tA, tX, tC, states, tg,
                                                    T)
    _close_to(got, _ref_grads(dA, dBx, C, gy), "backward from states")


@pytest.mark.parametrize("shape", CHUNK_SHAPES, ids=str)
def test_backward_from_states_is_the_full_h_backward_bit_for_bit(shape):
    _, (tA, tX, tC, tg) = _chunk_case(shape, 13)
    states = selective_scan_chunk_states_plain(tA, tX, T)
    got = selective_scan_backward_from_states_plain(tA, tX, tC, states, tg,
                                                    T)
    want = selective_scan_backward_plain(
        tA, tC, selective_scan_states_plain(tA, tX), tg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_backward_wrapper_on_cpu_takes_the_plain_version():
    """``selective_scan_backward`` on CPU tensors: the plain backward from
    the chunk states, no launch counted."""
    _, (tA, tX, tC, tg) = _chunk_case((2, T + 3, 4, 40), 14)
    states = selective_scan_chunk_states_plain(tA, tX, T)
    before = launch_count()
    got = selective_scan_backward(tA, tX, tC, states, tg)
    assert launch_count() == before
    want = selective_scan_backward_from_states_plain(tA, tX, tC, states, tg,
                                                     T)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
