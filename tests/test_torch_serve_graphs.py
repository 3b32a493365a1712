"""The serving tier's fixed per-bucket programs, on the CPU.

On a card the port captures each bucket geometry's forward once as a CUDA
graph (``serve/forward.py::BucketProgram``), where the reference jits one
forward per bucket (``repro/serve/forward.py``).  A graph replays one
grid, so each batch's work-unit table is padded to the geometry's bounds
(``PackGeom.bounds`` → ``kernels.paramspmm.ops.schedule_bounds``).  Here:

* Hypothesis-drawn batches inside every bucket of
  ``BucketPolicy.default()`` (uniform and skewed, under every config of
  ``config_space(64)``) fit their bucket's bounds; the padded table holds
  the unpadded table's units and split groups, then empty ones; a table
  past a bound raises;
* the kernels' arithmetic by units (``test_torch_schedule.py::
  emulate_spmm`` / ``emulate_stats``) over padded tables equals the plain
  versions and the reference's bucket forward on the same padded pack:
  bit-exact on integer operands, GAT within ``atol=1e-5`` (its softmax
  sums run in another order);
* the reference's soak contract (``tests/test_serve.py::
  test_soak_replay_deterministic_and_zero_recompiles``): one
  ``serve_recompiles_total`` per (bucket geometry, model) on the first
  pass, none on a second pass or after a cache eviction re-picks a
  geometry; the CPU counts a program's first forward, as the reference
  counts its trace;
* a program's buffers are refilled per batch: two batches in one bucket
  give what a fresh steering gives;
* ``SteeringPackCache(heads=4, op="gat")`` picks what the reference's
  cache picks on the same union CSR (the reference's cost constants).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.obs as robs
from repro.core.pcsr import SpMMConfig as RConfig
from repro.core.sparse import CSRMatrix as RCSR
from repro.models.gnn import init_gat, init_gcn, init_gin
from repro.serve import PackGeom as RGeom
from repro.serve import ShapeBucket as RBucket
from repro.serve import SteeringPackCache as RCache
from repro.serve import bucket_forward as r_bucket_forward
from repro.serve import pack_subgraph as r_pack
from repro.serve import steering_arrays as r_steering

import repro_torch.obs as tobs
from repro_torch.convert import params_to_torch
from repro_torch.core.pcsr import SpMMConfig, config_space
from repro_torch.core.sparse import CSRMatrix
from repro_torch.data.graphs import rmat
from repro_torch.kernels.paramspmm import ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.models import gnn as tgnn
from repro_torch.serve import (BucketPolicy, GNNService, PackGeom,
                               ShapeBucket, SteeringPackCache, bucket_forward,
                               pack_subgraph, replay, steering_arrays,
                               synthetic_stream)
from repro_torch.serve.forward import BucketProgram
from test_torch_pcsr import REF_HW
from test_torch_schedule import emulate_spmm, emulate_stats

BUCKETS = BucketPolicy.default().buckets
CONFIGS = config_space(64)
TINY_CAP = 4


def _batch(n, e, skew, seed):
    """``n`` nodes, up to ``e`` distinct edges with values ±1..3; rows
    drawn as ``⌊n·u^skew⌋`` so a large ``skew`` piles edges on the first
    rows (a hub block far above the mean)."""
    rng = np.random.default_rng(seed)
    rows = np.minimum((n * rng.random(e) ** skew).astype(np.int64), n - 1)
    cols = rng.integers(0, n, e)
    key = np.unique(rows * n + cols)
    rows, cols = key // n, key % n
    vals = rng.integers(1, 4, rows.size) * rng.choice([-1, 1], rows.size)
    return CSRMatrix.from_coo(rows, cols, vals.astype(np.float32), n, n,
                              sum_duplicates=False)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(bucket=st.sampled_from(BUCKETS), cfg=st.sampled_from(CONFIGS),
       fill=st.floats(0.0, 1.0), node_fill=st.floats(0.05, 1.0),
       skew=st.sampled_from([1.0, 3.0, 12.0]), tiny=st.booleans(),
       seed=st.integers(0, 2**16))
def test_batches_in_a_bucket_fit_its_bounds(bucket, cfg, fill, node_fill,
                                            skew, tiny, seed):
    n = max(1, int(bucket.n_ceil * node_fill))
    e = min(int(bucket.e_ceil * fill), n * n)
    csr = _batch(n, e, skew, seed)
    assert bucket.fits(csr.n_rows, csr.nnz)
    geom = PackGeom.from_bucket(bucket, cfg)
    bounds = geom.bounds(TINY_CAP if tiny else None)
    p = pack_subgraph(csr, geom)
    padded = ops.host_steering(p, bounds=bounds)          # does not raise
    assert padded["units"].shape == (bounds.n_units, 4)
    assert padded["splits"].shape == (bounds.n_splits, 3)
    assert (padded["n_partials"], padded["most"], padded["span"]) == (
        bounds.n_partials, bounds.most, bounds.span)
    # the real table first, then empty units and empty splits
    real = ops.host_steering(p, cap=bounds.cap)
    U, S = len(real["units"]), len(real["splits"])
    assert np.array_equal(padded["units"][:U], real["units"])
    n_slots = p.covered_num_chunks * p.K
    assert np.array_equal(padded["units"][U:], np.tile(
        [[n_slots, n_slots, -1, -1]], (bounds.n_units - U, 1)))
    assert np.array_equal(padded["splits"][:S], real["splits"])
    assert not padded["splits"][S:].any()
    assert real["n_partials"] <= bounds.n_partials
    for k in ("colidx", "lrow", "trow", "vals", "groups"):
        assert np.array_equal(padded[k], real[k])


def test_a_table_past_its_bounds_raises():
    bucket = ShapeBucket(256, 1024)
    geom = PackGeom.from_bucket(bucket, SpMMConfig(V=1, S=True, W=8))
    p = pack_subgraph(_batch(200, 1000, 12.0, 1), geom)
    bounds = geom.bounds(TINY_CAP)
    real = ops.host_steering(p, cap=TINY_CAP)
    assert len(real["splits"]) > 0
    for field, got in (("n_units", len(real["units"])),
                       ("n_splits", len(real["splits"])),
                       ("n_partials", real["n_partials"])):
        tight = dataclasses.replace(bounds, **{field: got - 1})
        with pytest.raises(ValueError, match="exceeds its bucket's bounds"):
            ops.host_steering(p, bounds=tight)
    with pytest.raises(ValueError, match="exceeds its bucket's bounds"):
        ops.host_steering(p, bounds=dataclasses.replace(bounds, most=1))


# ----------------------------------------------------------- emulation
def _union(seed=5, requests=6):
    g = rmat(10, 6, seed=seed)
    reqs = synthetic_stream(requests, g.n_rows, seed=seed)
    from repro_torch.data.graphs import extract_subgraph, sample_khop
    subs = [extract_subgraph(g, sample_khop(g, r.seeds, r.fanouts,
                                            seed=r.sample_seed))
            for r in reqs]
    rows, cols, off = [], [], 0
    for s in subs:
        r = np.repeat(np.arange(s.n_rows), np.diff(s.indptr))
        rows.append(r + off)
        cols.append(s.indices + off)
        off += s.n_rows
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.random.default_rng(seed).integers(1, 3, rows.size)
    return CSRMatrix.from_coo(rows, cols, vals.astype(np.float32), off, off,
                              sum_duplicates=False)


def _int_params(params, scale=2.0):
    return [{k: np.round(np.asarray(v) * scale) for k, v in l.items()}
            for l in params]


EMU_CONFIGS = [SpMMConfig(V=1, S=False, W=8), SpMMConfig(V=2, S=True, W=8),
               SpMMConfig(V=1, S=True, B=True, W=32),
               SpMMConfig(V=2, S=True, B=True, W=16)]
DIMS = [8, 16, 16, 4]


def _emulated_closures(steer, geom):
    """The served forward's aggregation closures, computed by units over
    the padded table as the kernels compute it."""
    cfg = geom.config
    geo = dict(V=cfg.V, R=cfg.R, K=geom.K, n_blocks=geom.n_blocks,
               n_rows=geom.n_rows)

    def fused(B, scale=None, bias=None, activation="none", residual=None):
        return emulate_spmm(steer, B, scale=scale, bias=bias,
                            residual=residual, activation=activation, **geo)

    def spmm(B):
        return fused(B)
    spmm.fused = fused

    def msg(Q, K_mat, Vf):
        logits, _, _ = sddmm_ops.sddmm_softmax_plain(
            steer, Q[None], K_mat[None], scale=float(1.0 / np.sqrt(
                Q.shape[-1])), slope=0.2, **geo)
        m, s = emulate_stats(steer, logits[0], V=cfg.V, R=cfg.R, K=geom.K,
                             n_blocks=geom.n_blocks)
        alpha = sddmm_ops.normalize_from_stats(
            logits[0], m, s, steer.lrow, steer.trow, R=cfg.R, V=cfg.V,
            K=geom.K)
        return emulate_spmm(steer, Vf, vals=alpha, **geo)
    return spmm, msg


@pytest.mark.parametrize("tiny", [False, True], ids=["cap", "tiny"])
@pytest.mark.parametrize("model", ["gcn", "gin", "gat"])
@pytest.mark.parametrize("cfg", EMU_CONFIGS, ids=lambda c: str(c.astuple()))
def test_emulated_padded_forward_matches_plain_and_reference(cfg, model,
                                                             tiny):
    union = _union()
    bucket = BucketPolicy.default().pick(union.n_rows, union.nnz)
    geom = PackGeom.from_bucket(bucket, cfg)
    p = pack_subgraph(union, geom)
    bounds = geom.bounds(TINY_CAP if tiny else None)
    steer = ops.Steering.from_pcsr(p, "cpu", bounds=bounds)
    assert steer.n_units == bounds.n_units
    if tiny:
        assert bool((steer.units[:, 3] >= 0).any()), "no split group"
    assert bool((steer.units[:, 0] == steer.units[:, 1]).any()), \
        "no padding unit"
    rng = np.random.default_rng(7)
    X = rng.integers(0, 3, (geom.n_rows, DIMS[0])).astype(np.float32)
    init = {"gcn": init_gcn, "gin": init_gin, "gat": init_gat}[model]
    jparams = init(jax.random.PRNGKey(3), DIMS)
    np_params = (_int_params(jparams) if model != "gat" else
                 jax.tree_util.tree_map(np.asarray, jparams))
    tparams = params_to_torch(np_params)
    Xt = torch.from_numpy(X)
    spmm, msg = _emulated_closures(steer, geom)
    if model == "gat":
        got = tgnn.gat_forward(tparams, Xt, msg)
    else:
        got = getattr(tgnn, f"{model}_forward")(tparams, Xt, spmm)
    plain = bucket_forward(steer, Xt, tparams, geom=geom, model=model)
    rgeom = RGeom.from_bucket(RBucket(bucket.n_ceil, bucket.e_ceil),
                              RConfig(V=cfg.V, S=cfg.S, F=cfg.F, W=cfg.W,
                                      B=cfg.B))
    rp = r_pack(RCSR(union.indptr, union.indices, union.data, union.n_rows,
                     union.n_cols), rgeom)
    want = np.asarray(r_bucket_forward(r_steering(rp), X, np_params,
                                       geom=rgeom, model=model))
    if model == "gat":
        torch.testing.assert_close(got, plain, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        assert torch.equal(got, plain)
        assert np.array_equal(got.numpy(), want)


# ------------------------------------------------- soak, programs, cache
def _service_inputs(seed=6):
    g = rmat(10, 6, seed=seed)
    g.data = np.ones_like(g.data)
    feats = np.random.default_rng(seed).integers(
        0, 3, (g.n_rows, 24)).astype(np.float32)
    params = params_to_torch(_int_params(init_gcn(jax.random.PRNGKey(2),
                                                  [24, 40, 6])))
    return g, feats, params


def _recompiles():
    return sum(tobs.metrics_snapshot().get("serve_recompiles_total",
                                           {}).values())


def test_soak_second_pass_adds_no_program():
    g, feats, params = _service_inputs()
    pol = BucketPolicy([ShapeBucket(256, 2048), ShapeBucket(512, 4096),
                        ShapeBucket(1024, 8192)])
    stream = synthetic_stream(24, g.n_rows, seed=13)
    with tobs.tracing():
        svc = GNNService(g, feats, params, device="cpu", policy=pol)
        assert not svc.graphs
        out1 = replay(svc, stream, tick_every=4)
        warm = _recompiles()
        buckets_used = {b for b, _ in svc.batch_log}
        assert warm == svc.compiled_buckets == len(buckets_used) > 0
        log1 = list(svc.batch_log)
        out2 = replay(svc, stream, tick_every=4)
        assert _recompiles() == warm, "a program was built after warm-up"
        labels = set(tobs.metrics_snapshot()["serve_recompiles_total"])
    assert all("backend=cpu" in k and "model=gcn" in k for k in labels)
    assert svc.batch_log[len(log1):] == log1
    for a, b in zip(out1, out2):
        assert a.rid == b.rid and np.array_equal(a.outputs, b.outputs)


def test_evicted_bucket_reuses_its_program():
    """Capacity 1: every change of bucket evicts the other's pick.  A
    re-pick that lands on a geometry seen before reuses its program, so
    programs (and ``serve_recompiles_total``) count distinct geometries,
    fewer than the misses."""
    g, feats, params = _service_inputs()
    pol = BucketPolicy.default(n_min=16, e_min=64, n_max=256, e_max=2048)
    with tobs.tracing():
        svc = GNNService(g, feats, params, device="cpu", policy=pol,
                         cache_capacity=1)
        res = replay(svc, synthetic_stream(24, g.n_rows, seed=13),
                     tick_every=2)
        geoms = {(r.bucket_key, r.config) for r in res}
        assert svc.cache.evictions > 0
        assert svc.cache.misses > svc.compiled_buckets
        assert _recompiles() == svc.compiled_buckets == len(geoms)


def test_program_refills_its_buffers_per_batch():
    """Two batches in one bucket through one program: each output equals
    the forward on a fresh steering of that batch."""
    geom = PackGeom.from_bucket(ShapeBucket(256, 2048),
                                SpMMConfig(V=2, S=True, W=8))
    _, _, params = _service_inputs()
    rng = np.random.default_rng(0)
    packs = [pack_subgraph(_batch(n, e, 6.0, s), geom)
             for n, e, s in ((200, 1500, 1), (120, 700, 2))]
    prog = BucketProgram(geom, packs[0], params, 24, "cpu", model="gcn",
                         graphs=False)
    for p in packs:
        X = rng.integers(0, 3, (p.n_rows - 30, 24)).astype(np.float32)
        Xp = np.zeros((geom.n_rows, 24), np.float32)
        Xp[:len(X)] = X
        want = bucket_forward(steering_arrays(p, "cpu"),
                              torch.from_numpy(Xp), params, geom=geom,
                              model="gcn")
        assert torch.equal(prog(p, X), want)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        BucketProgram(geom, packs[0], params, 24, "cpu", model="gcn",
                      graphs=True)


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_gat_cache_with_heads_picks_as_the_reference(seed, heads):
    union = _union(seed, requests=4 + 2 * seed)
    bucket = BucketPolicy.default().pick(union.n_rows, union.nnz)
    rb = RBucket(bucket.n_ceil, bucket.e_ceil)
    rcsr = RCSR(union.indptr, union.indices, union.data, union.n_rows,
                union.n_cols)
    with robs.tracing():
        want = RCache(dim=64, op="gat", heads=heads).get(rb, rcsr)
    got = SteeringPackCache(dim=64, op="gat", heads=heads,
                            hardware=REF_HW).get(bucket, union)
    assert got.config.astuple() == want.config.astuple()
    assert (got.geom.n_rows, got.geom.num_chunks, got.geom.K) == (
        want.geom.n_rows, want.geom.num_chunks, want.geom.K)


def test_service_refuses_graphs_off_the_card():
    g, feats, params = _service_inputs()
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        GNNService(g, feats, params, device="cpu", graphs=True)
