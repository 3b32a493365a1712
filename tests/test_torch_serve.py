"""PyTorch port vs JAX reference: the GNN serving tier, end to end.

The port's ``GNNService(device="cpu")`` — which serves through the
kernels' plain versions on CPU tensors — and the JAX ``GNNService``
(engine backend) replay the same seeded request stream over the same
graph with the same parameters (carried across by ``repro_torch.convert``).
With integer-valued features, weights and edge values every GCN/GIN
output is bit-exact; GAT's softmax sums run in another order, so its
outputs agree within ``atol=1e-5`` (the reference's own serving
tolerance).  Batch composition, bucket keys, the per-bucket configs
(priced with the reference's constants, ``op="gat"`` for GAT) and the
cache counters are equal too.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core.cost_model as rcm
from repro.data.graphs import rmat as r_rmat
from repro.models.gnn import init_gat, init_gcn, init_gin
from repro.serve import GNNService as RService
from repro.serve import PackGeom as RGeom
from repro.serve import ShapeBucket as RBucket
from repro.serve import pack_subgraph as r_pack
from repro.serve import replay as r_replay
from repro.serve import synthetic_stream as r_stream

import repro_torch.obs as tobs
from repro_torch.convert import params_to_torch
from repro_torch.core.cost_model import Hardware
from repro_torch.core.pcsr import SpMMConfig
from repro_torch.data.graphs import rmat as t_rmat
from repro_torch.kernels.paramspmm import ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.serve import (GNNService, PackGeom,
                               ShapeBucket, SteeringPackCache, pack_subgraph,
                               reference_forward, replay, steering_arrays,
                               synthetic_stream)

REF_HW = Hardware(hbm_bw=rcm.HBM_BW, flops=rcm.VPU_FLOPS,
                  step_overhead=rcm.STEP_OVERHEAD,
                  chunk_setup=rcm.CHUNK_SETUP, dtype_bytes=rcm.DTYPE_BYTES)
DIMS = [8, 16, 16, 4]      # unfused first layer, fused hidden + last layers


def _int_params(params, scale=2.0):
    """Integer-valued parameters: GCN/GIN sums are then exact under any
    summation order, so bit-equality is well-defined."""
    return [{k: np.round(np.asarray(v) * scale) for k, v in l.items()}
            for l in params]


def _graphs(seed):
    r, t = r_rmat(10, 6, seed=seed), t_rmat(10, 6, seed=seed)
    r.data = np.ones_like(r.data)
    t.data = np.ones_like(t.data)
    return r, t


@pytest.mark.parametrize("model", ["gcn", "gin", "gat"])
@pytest.mark.parametrize("seeds", [(1, 3), (4, 11)], ids=str)
def test_service_bit_equal_to_reference_service(model, seeds):
    graph_seed, stream_seed = seeds
    g_r, g_t = _graphs(graph_seed)
    rng = np.random.default_rng(graph_seed)
    feats = rng.integers(0, 3, (g_r.n_rows, DIMS[0])).astype(np.float32)
    init = {"gcn": init_gcn, "gin": init_gin, "gat": init_gat}[model]
    # GCN/GIN: integer weights, so sums are exact in any order.  GAT is
    # not bit-exact anyway (softmax), so it keeps the He-init float
    # weights: outputs of order 1, where atol=1e-5 is a few float32 ulps
    params = init(jax.random.PRNGKey(graph_seed), DIMS)
    np_params = (_int_params(params) if model != "gat" else
                 jax.tree_util.tree_map(np.asarray, params))
    ref = RService(g_r, feats, np_params, model=model, backend="engine")
    port = GNNService(g_t, feats, params_to_torch(np_params), model=model,
                      device="cpu", hardware=REF_HW, keep_subgraphs=True)
    stream = synthetic_stream(10, g_t.n_rows, seed=stream_seed)
    assert ([dataclasses.astuple(r) for r in stream]
            == [dataclasses.astuple(r)
                for r in r_stream(10, g_r.n_rows, seed=stream_seed)])
    launches = (ops.launch_count(), sddmm_ops.launch_count())
    want = r_replay(ref, r_stream(10, g_r.n_rows, seed=stream_seed),
                    tick_every=3)
    got = replay(port, stream, tick_every=3)
    assert (ops.launch_count(), sddmm_ops.launch_count()) == launches, \
        "CPU serving launches nothing"
    same = ((lambda a, b: np.array_equal(a, b)) if model != "gat" else
            (lambda a, b: np.allclose(a, b, rtol=0, atol=1e-5)))

    assert port.batch_log == ref.batch_log
    assert (port.cache.hits, port.cache.misses, port.cache.evictions) == \
        (ref.cache.hits, ref.cache.misses, ref.cache.evictions)
    assert port.compiled_buckets == ref.compiled_buckets
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert a.rid == b.rid and a.bucket_key == b.bucket_key
        assert a.config.astuple() == b.config.astuple()
        assert a.outputs.dtype == np.float32
        assert same(a.outputs, np.asarray(b.outputs)), a.rid
        # and against the port's own unbucketed reference forward
        sr = a.sampled
        one = reference_forward(sr.sub, torch.from_numpy(feats[sr.nodes]),
                                port.params, model=model, config=a.config)
        assert same(a.outputs, one.numpy()[sr.seed_local])


@pytest.mark.parametrize("cfg", [SpMMConfig(V=1, S=False, W=8),
                                 SpMMConfig(V=2, S=True, W=8),
                                 SpMMConfig(V=1, S=True, W=16, B=True)],
                         ids=lambda c: str(c.astuple()))
def test_pack_geometry_matches_reference(cfg):
    from repro.core.pcsr import SpMMConfig as RConfig
    rcfg = RConfig(V=cfg.V, S=cfg.S, F=cfg.F, W=cfg.W, B=cfg.B)
    g_r, g_t = _graphs(5)
    for bucket in ((256, 2048), (128, 512)):
        geom_r = RGeom.from_bucket(RBucket(*bucket), rcfg)
        geom_t = PackGeom.from_bucket(ShapeBucket(*bucket), cfg)
        assert (geom_t.n_rows, geom_t.n_blocks, geom_t.num_chunks,
                geom_t.K) == (geom_r.n_rows, geom_r.n_blocks,
                              geom_r.num_chunks, geom_r.K)
    from repro.core.sparse import CSRMatrix as RCSR
    from repro_torch.core.sparse import CSRMatrix as TCSR
    sub = np.arange(100)
    A = g_r.to_dense()[np.ix_(sub, sub)]
    p_r = r_pack(RCSR.from_dense(A), geom_r)
    p_t = pack_subgraph(TCSR.from_dense(A), geom_t)
    st_r, st_t = p_r.steering(), p_t.steering(covered=True)
    for f in ("colidx", "lrow", "trow", "init", "fini", "vals"):
        assert np.array_equal(st_r[f], st_t[f]), f
    steer = steering_arrays(p_t, "cpu")
    assert steer.n_groups == geom_t.n_blocks
    assert steer.groups.dtype == torch.int32


def test_pack_shapes_identical_across_subgraphs():
    from repro_torch.data.graphs import er
    geom = PackGeom.from_bucket(ShapeBucket(256, 2048),
                                SpMMConfig(V=1, S=True, W=8))
    shapes = []
    for seed in (1, 2):
        steer = steering_arrays(pack_subgraph(er(100 + 40 * seed, 6,
                                                 seed=seed), geom), "cpu")
        shapes.append({f: tuple(getattr(steer, f).shape)
                       for f in ("colidx", "lrow", "trow", "vals",
                                 "groups")})
    assert shapes[0] == shapes[1]


def test_cache_counters_and_obs_mirror():
    from repro_torch.data.graphs import er
    a, b = ShapeBucket(128, 512), ShapeBucket(256, 1024)
    g = er(100, 5, seed=0)
    with tobs.tracing():
        cache = SteeringPackCache(dim=16, capacity=1)
        pa1 = cache.get(a, g)
        pa2 = cache.get(a, g)
        cache.get(b, g)                         # evicts a
        snap = tobs.metrics_snapshot()
    assert (cache.hits, cache.misses, cache.evictions) == (1, 2, 1)
    assert pa1 is pa2
    assert snap["serve_cache_hits_total"] == {f"bucket={a.key}": 1.0}
    assert sum(snap["serve_cache_evictions_total"].values()) == 1


def test_traced_service_records_spans(tmp_path):
    import json
    g_r, g_t = _graphs(2)
    feats = np.ones((g_t.n_rows, 8), np.float32)
    params = params_to_torch(_int_params(init_gcn(jax.random.PRNGKey(0),
                                                  [8, 8, 4])))
    path = str(tmp_path / "trace.json")
    with tobs.tracing(path):
        svc = GNNService(g_t, feats, params, device="cpu")
        replay(svc, synthetic_stream(4, g_t.n_rows, seed=1), tick_every=2)
    trace = json.load(open(path))
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"serve.sample", "serve.batch", "serve.pack",
            "serve.forward", "pcsr.build"} <= names
    assert "serve_requests_total" in trace["repro_metrics"]
    assert not tobs.trace_enabled()


def test_service_refuses_gat_and_missing_cuda(monkeypatch):
    """GAT is served now; an unknown model is refused, and every model
    refuses to run without a card unless asked for the CPU."""
    g_r, g_t = _graphs(3)
    feats = np.ones((g_t.n_rows, 8), np.float32)
    params = {m: params_to_torch(_int_params(init(jax.random.PRNGKey(0),
                                                  [8, 4])))
              for m, init in (("gcn", init_gcn), ("gat", init_gat))}
    with pytest.raises(ValueError, match="unknown model"):
        GNNService(g_t, feats, params["gcn"], model="sage", device="cpu")
    svc = GNNService(g_t, feats, params["gat"], model="gat", device="cpu")
    assert svc.cache.op == "gat"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in ("gcn", "gat"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GNNService(g_t, feats, params[model], model=model)  # cuda
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GNNService(g_t, feats, params[model], model=model,
                       device="cuda")


def test_convert_carries_params_across():
    np_params = _int_params(init_gin(jax.random.PRNGKey(1), [4, 6, 2]))
    tparams = params_to_torch(np_params)
    for a, b in zip(np_params, tparams):
        assert a.keys() == b.keys()
        for k in a:
            assert b[k].dtype == torch.float32
            assert np.array_equal(np.asarray(a[k], np.float32), b[k].numpy())
    with pytest.raises(ValueError, match="keys"):
        params_to_torch([{"w": np.zeros((2, 2))}])


def test_serve_gnn_cli_cpu_check(tmp_path):
    from repro_torch.apps.serve_gnn import main
    stats = main(["--device", "cpu", "--graph", "grid128", "--requests",
                  "6", "--tick-every", "2", "--check", "--stats",
                  str(tmp_path / "s.json")])
    assert stats["checked"] == 6 and stats["kernel_launches"] == 0
    assert stats["cache_hits"] > 0
