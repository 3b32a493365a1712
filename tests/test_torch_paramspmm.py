"""PyTorch port vs JAX reference: the ParamSpMM operator.

``paramspmm_plain`` (the CUDA kernel's plain version, which the wrapper
runs on CPU tensors) is held against the JAX engine ``_engine`` plus
``apply_epilogue`` across V, S, B, F and every epilogue variant: to
float32 ``atol=1e-4`` with float operands (the two sum in different
orders) and bit-exact with integer-valued operands (integer sums are
order-free).  A few tiny cases go through the Pallas kernel in interpret
mode.  The CUDA kernel itself runs only on the card: its tests are in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as rengine
from repro.core import pcsr as rp
from repro.kernels.paramspmm import ops as rops
from repro.kernels.paramspmm.ref import spmm_ref as r_spmm_ref

from repro_torch.core import pcsr as tp
from repro_torch.core.engine import engine_spmm
from repro_torch.kernels.paramspmm import ops
from repro_torch.kernels.paramspmm.ref import spmm_ref

from conftest import random_csr

ATOL = 1e-4          # float32 operands, sums in different orders

EPILOGUES = {
    "none": {},
    "scale": {"scale": True},
    "bias": {"bias": True},
    "residual": {"residual": True},
    "relu": {"bias": True, "activation": "relu"},
    "leaky_relu": {"scale": True, "activation": "leaky_relu"},
    "all": {"scale": True, "bias": True, "residual": True,
            "activation": "relu"},
}

CONFIGS = [tp.SpMMConfig(V=v, S=s, B=b, F=f, W=r // v)
           for v in (1, 2) for (s, b) in ((False, False), (True, False),
                                          (True, True))
           for f, r in ((1, 16), (2, 8))]


def _pair(cfg, n=70, seed=0, integer=False):
    """(reference PCSR, port PCSR) of one skewed graph with empty rows."""
    rng = np.random.default_rng(seed)
    csr, A = random_csr(rng, n, density=0.06, skew=True)
    A[20:45] = 0.0
    if integer:
        A = np.round(A * 2)
    from repro.core.sparse import CSRMatrix
    csr = CSRMatrix.from_dense(A)
    rcfg = rp.SpMMConfig(V=cfg.V, S=cfg.S, F=cfg.F, W=cfg.W, B=cfg.B)
    args = (csr.indptr, csr.indices, csr.data, csr.n_rows, csr.n_cols)
    return csr, rp.build_pcsr(*args, rcfg), tp.build_pcsr(*args, cfg)


def _operands(rng, n, dim, spec, integer):
    draw = ((lambda *s: rng.integers(-3, 4, s).astype(np.float32))
            if integer else
            (lambda *s: rng.standard_normal(s).astype(np.float32)))
    B = draw(n, dim)
    epi = {"activation": spec.get("activation", "none")}
    for name, shape in (("scale", (n,)), ("bias", (dim,)),
                        ("residual", (n, dim))):
        if spec.get(name):
            epi[name] = draw(*shape)
    return B, epi


def _reference(rpcsr, B, epi):
    """JAX engine + apply_epilogue on the reference pack."""
    st = rpcsr.steering()
    cfg = rpcsr.config
    out = rengine._engine(jnp.asarray(st["colidx"]), jnp.asarray(st["lrow"]),
                          jnp.asarray(st["trow"]), jnp.asarray(st["vals"]),
                          jnp.asarray(B), V=cfg.V, R=cfg.R, K=rpcsr.K,
                          n_blocks=rpcsr.n_blocks, n_rows=rpcsr.n_rows)
    kw = {k: (jnp.asarray(v) if k != "activation" else v)
          for k, v in epi.items()}
    return np.asarray(rengine.apply_epilogue(out, **kw))


def _port_plain(tpcsr, B, epi):
    cfg = tpcsr.config
    steer = ops.device_steering(tpcsr, "cpu")
    kw = {k: (torch.from_numpy(v) if k != "activation" else v)
          for k, v in epi.items()}
    return ops.paramspmm_plain(
        steer, torch.from_numpy(B), V=cfg.V, R=cfg.R, K=tpcsr.K,
        n_blocks=tpcsr.n_blocks, n_rows=tpcsr.n_rows, **kw).numpy()


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: str(c.astuple()))
def test_plain_matches_engine_and_epilogue(cfg, epilogue):
    dim = 64 * cfg.F + 8                     # ragged last dim tile
    for integer in (False, True):
        csr, r, t = _pair(cfg, integer=integer)
        rng = np.random.default_rng(1)
        B, epi = _operands(rng, csr.n_rows, dim, EPILOGUES[epilogue],
                           integer)
        want = _reference(r, B, epi)
        got = _port_plain(t, B, epi)
        assert got.shape == want.shape == (csr.n_rows, dim)
        if integer:
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        # the public entry point takes the same (plain) path on CPU
        kw = {k: (torch.from_numpy(v) if k != "activation" else v)
              for k, v in epi.items()}
        launches = ops.launch_count()
        via = ops.paramspmm(t, torch.from_numpy(B), **kw).numpy()
        assert np.array_equal(via, got)
        assert ops.launch_count() == launches, "CPU tensors launch nothing"


@pytest.mark.parametrize("case", [
    (tp.SpMMConfig(V=1, S=True, W=8), "relu"),
    (tp.SpMMConfig(V=2, S=True, W=4, B=True), "leaky_relu"),
    (tp.SpMMConfig(V=2, S=False, W=8), "none"),
], ids=["v1s", "v2sb", "v2"])
def test_port_matches_pallas_interpret(case):
    cfg, act = case
    rng = np.random.default_rng(7)
    csr, A = random_csr(rng, 24, density=0.15, skew=True)
    A[8:16] = 0.0
    from repro.core.sparse import CSRMatrix
    csr = CSRMatrix.from_dense(A)
    args = (csr.indptr, csr.indices, csr.data, csr.n_rows, csr.n_cols)
    r = rp.build_pcsr(*args, rp.SpMMConfig(V=cfg.V, S=cfg.S, F=cfg.F,
                                           W=cfg.W, B=cfg.B))
    t = tp.build_pcsr(*args, cfg)
    B, epi = _operands(rng, 24, 8, {"scale": True, "bias": True,
                                    "residual": True, "activation": act},
                       integer=False)
    want = np.asarray(rops.paramspmm(
        r, jnp.asarray(B), scale=jnp.asarray(epi["scale"]),
        bias=jnp.asarray(epi["bias"]), residual=jnp.asarray(epi["residual"]),
        activation=act, interpret=True))
    got = ops.paramspmm(t, torch.from_numpy(B),
                        scale=torch.from_numpy(epi["scale"]),
                        bias=torch.from_numpy(epi["bias"]),
                        residual=torch.from_numpy(epi["residual"]),
                        activation=act).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_spmm_ref_and_engine_match_reference(seed):
    rng = np.random.default_rng(seed)
    csr, A = random_csr(rng, 50, density=0.1, skew=bool(seed))
    B = rng.standard_normal((50, 24)).astype(np.float32)
    want = np.asarray(r_spmm_ref(csr.indptr, csr.indices, csr.data,
                                 jnp.asarray(B), csr.n_rows))
    got = spmm_ref(csr.indptr, csr.indices, csr.data, torch.from_numpy(B),
                   csr.n_rows).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, A @ B, rtol=0, atol=ATOL)
    for cfg in CONFIGS:
        t = tp.build_pcsr(csr.indptr, csr.indices, csr.data, 50, 50, cfg)
        np.testing.assert_allclose(
            engine_spmm(t, torch.from_numpy(B)).numpy(), want, rtol=0,
            atol=ATOL)


def test_group_table_one_group_per_block():
    for cfg in CONFIGS:
        _, _, t = _pair(cfg)
        st = t.steering(covered=True)
        g = ops.group_table(st["trow"], st["init"], st["fini"], t.n_blocks)
        assert g.dtype == np.int32 and g.shape == (t.n_blocks + 1,)
        assert g[0] == 0 and g[-1] == t.covered_num_chunks
        assert np.all(np.diff(g) > 0)
        assert sorted(st["trow"][g[:-1]]) == list(range(t.n_blocks))


def test_group_table_rejects_uncovered_and_split_groups():
    cfg = tp.SpMMConfig(V=1, S=True, W=8)
    _, _, t = _pair(cfg)
    assert t.n_empty_blocks > 0
    st = t.steering(covered=False)
    with pytest.raises(ValueError, match="group"):
        ops.group_table(st["trow"], st["init"], st["fini"], t.n_blocks)
    # one block's chunks in two separate runs would be two racing groups
    trow = np.array([0, 1, 0], np.int32)
    one = np.ones(3, np.int32)
    with pytest.raises(ValueError, match="group"):
        ops.group_table(trow, one, one, 2)


def test_wrapper_rejects_bad_operands():
    cfg = tp.SpMMConfig(V=1, S=False, W=8)
    csr, _, t = _pair(cfg)
    B = torch.zeros((csr.n_rows, 16))
    with pytest.raises(ValueError, match="activation"):
        ops.paramspmm(t, B, activation="gelu")
    with pytest.raises(ValueError, match="bias"):
        ops.paramspmm(t, B, bias=torch.zeros(15))
    with pytest.raises(ValueError, match="residual"):
        ops.paramspmm(t, B, residual=torch.zeros((csr.n_rows, 15)))
    with pytest.raises(ValueError, match="B must be"):
        ops.paramspmm(t, torch.zeros((csr.n_rows - 1, 16)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.paramspmm(t, B.to("meta"))
