"""PyTorch port vs JAX reference: the distributed graph operators
(``repro_torch.dist``, multi-controller over ``torch.distributed``).

* The host plan is array-equal with the reference's: ``partition_bounds``,
  ``partition_csr`` (starts, pads, each shard's CSR, ``halo_global``),
  ``build_halo``, ``split_local_halo``, and ``DistGraph``'s per-shard
  configs (and overlap sub-configs) priced at the reference's constants,
  on power-law, ER, grid, SBM and random graphs, both strategies.
* One group of 4 gloo ranks on the CPU, spawned once for the module,
  runs every operator case: ``dist_spmm`` and ``fused`` (relu, bias,
  scale) forward and gradients, overlap off and on, ``dist_gat_message``
  at 1, 2, 3 and 4 heads, an empty shard and a halo-heavy ER graph.  They
  are held against the JAX package's ``DistGraph`` (engine backend),
  which runs in two subprocesses over 4 host devices: SpMM and fused SpMM
  bit-equal on integer-valued operands, GAT within ``rtol=atol=1e-5``;
  and against the reference's single-device ``engine_spmm`` /
  ``make_gat_message_fn`` at the same tolerances.
* The same group trains GCN, GIN and GAT (1 and 4 heads) partitioned over
  2 ranks (two subgroups) and over 4 (balanced, contiguous, overlap): the
  losses within ``rtol=1e-4`` of the port's single-device CPU training
  with reorder off (4-head GAT: ``1e-4`` over 3 steps, ``1e-3`` over 10),
  equal val_acc, parameters bit-equal on every rank.
* Backend and device choice: NCCL needs a card per rank; gloo shares.
* ``cuda``-marked: the operator cases on the card, 4 gloo ranks sharing
  it, against the single-device kernels there (no JAX needed:
  ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dist.py``).
"""
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.cost_model import Hardware
from repro_torch.core.sparse import CSRMatrix as TCSR

ROOT = pathlib.Path(__file__).resolve().parents[1]
P = 4
GAT_TOL = dict(rtol=1e-5, atol=1e-5)
RTOL = 1e-4
MH_RTOL, MH_HELD_STEPS = 1e-3, 3
TRAIN_TASK = dict(n_blocks=6, block_size=32, feat_dim=16, p_in=0.2, seed=2)


def _ref_hw():
    import repro.core.cost_model as rcm
    return Hardware(hbm_bw=rcm.HBM_BW, flops=rcm.VPU_FLOPS,
                    step_overhead=rcm.STEP_OVERHEAD,
                    chunk_setup=rcm.CHUNK_SETUP, dtype_bytes=rcm.DTYPE_BYTES)


def _ref(c):
    """The port's CSR as the reference's."""
    from repro.core import CSRMatrix
    return CSRMatrix(c.indptr.copy(), c.indices.copy(), c.data.copy(),
                     c.n_rows, c.n_cols)


def _graph(kind, seed=0):
    """Test graphs from the port's generators (seed-for-seed equal to the
    reference's, ``test_torch_graphs.py``); numpy only, so the card's
    cases build them too."""
    from repro_torch.data.graphs import er, grid2d, rmat, sbm
    if kind == "rmat":
        return rmat(9, 8, seed=seed)
    if kind == "er":
        return er(300, 6, seed=seed)
    if kind == "er_gat":
        return er(120, 12, seed=seed)
    if kind == "grid":
        return grid2d(20, seed=seed)
    if kind == "sbm":
        return sbm(6, 64, 0.2, 1.0, seed=seed)
    rng = np.random.default_rng(seed)
    A = (rng.random((150, 150)) < 0.06) * rng.standard_normal((150, 150))
    A[rng.integers(0, 150, 6)] *= rng.random(150) < 0.5   # skewed rows
    if kind == "empty":                  # shard 1 of a 4-way contiguous
        A = A[:96, :96].copy()           # split owns no edge
        A[24:48] = 0.0
    return TCSR.from_dense(A.astype(np.float32))


def _integer(csr, rng):
    """The same pattern with values in {1, 2, 3}: sums stay exact."""
    return TCSR(csr.indptr, csr.indices,
                rng.integers(1, 4, csr.nnz).astype(np.float32), csr.n_rows,
                csr.n_cols)


def _csr_tuple(c):
    return (c.indptr, c.indices, c.data, c.n_rows, c.n_cols)


# ------------------------------------------------------------ cases
SPMM_CASES = (
    # name, graph, strategy, overlap, fused too
    ("rmat_bal", "rmat", "balanced", False, True),
    ("rmat_bal_ovl", "rmat", "balanced", True, True),
    ("er_cont", "er", "contiguous", False, True),
    ("er_cont_ovl", "er", "contiguous", True, False),
    ("empty", "empty", "contiguous", False, True),
    ("empty_ovl", "empty", "contiguous", True, True),
)
GAT_CASES = (
    # name, graph, strategy, heads, d_qk, d_v
    ("sbm_h1", "sbm", "contiguous", 1, 16, 20),
    ("sbm_h4", "sbm", "balanced", 4, 8, 8),
    ("er_h2", "er_gat", "balanced", 2, 8, 8),
    ("empty_h3", "empty", "contiguous", 3, 8, 12),
)
TRAIN_CASES = (
    # model, heads, partitions, strategy, overlap, steps, fused
    ("gcn", 1, 2, "balanced", False, 8, True),
    ("gin", 1, 2, "balanced", False, 8, True),
    ("gat", 1, 2, "balanced", False, 6, True),
    ("gat", 4, 2, "balanced", False, 10, True),
    ("gcn", 1, 2, "balanced", False, 8, False),
    ("gcn", 1, 4, "balanced", False, 8, True),
    ("gcn", 1, 4, "contiguous", False, 8, True),
    ("gcn", 1, 4, "balanced", True, 8, True),
    ("gin", 1, 4, "balanced", False, 8, True),
    ("gin", 1, 4, "contiguous", True, 8, True),
    ("gin", 1, 4, "balanced", True, 8, False),
    ("gat", 1, 4, "balanced", False, 6, True),
    ("gat", 4, 4, "contiguous", False, 10, True),
)

REFRESH_CASES = (
    # name, rmat (log2 n, degree, seed), dim, overlap, mutated shard, new
    # edges inside it (None: edges to remote columns that grow halo_pad),
    # drift threshold
    ("refresh_identity", (8, 6, 11), 16, False, 1, 10, None),
    ("refresh_repick", (8, 7, 9), 16, False, 0, 40, 1e-6),
    ("refresh_overlap", (8, 6, 21), 12, True, 3, 12, None),
    ("refresh_halo_grows", (8, 6, 5), 16, False, 0, None, None),
)


def _train_id(c):
    model, heads, parts, strategy, overlap, _, fused = c
    return (f"{model}{'_mh' if heads > 1 else ''}-p{parts}-{strategy}"
            + ("-overlap" if overlap else "")
            + ("" if fused else "-unfused"))


def _mutated(csr, rng, shard, n_new):
    """``csr`` with integer-valued edges added whose rows and columns lie
    inside one shard's rows (the balanced 4-way split): only that shard's
    edges change and no halo grows.  ``n_new=None``: edges from the
    shard's rows to remote columns outside its halo, enough to outgrow
    ``halo_pad``."""
    from repro_torch.dist import partition_csr
    part = partition_csr(csr, P, "balanced")
    lo, hi = int(part.starts[shard]), int(part.starts[shard + 1])
    A = csr.to_dense()
    if n_new is None:
        remote = np.setdiff1d(np.r_[0:lo, hi:csr.n_rows],
                              part.shards[shard].halo_global)
        n_new = part.halo_pad - part.shards[shard].n_halo + 8
        c = rng.choice(remote, n_new, replace=False)
    else:
        c = rng.integers(lo, hi, n_new)
    A[rng.integers(lo, hi, n_new), c] = rng.integers(1, 4, n_new)
    return TCSR.from_dense(A.astype(np.float32))


def _inputs():
    """Every operator case's graph and operands, drawn once with numpy."""
    from repro_torch.data.graphs import rmat
    rng = np.random.default_rng(11)
    spmm, gat, refresh = [], [], []
    for name, kind, strategy, overlap, fused in SPMM_CASES:
        csr = _integer(_graph(kind, seed=5), np.random.default_rng(5))
        n, d = csr.n_rows, 16
        ints = lambda *s: rng.integers(-3, 4, s).astype(np.float32)
        spmm.append(dict(name=name, csr=_csr_tuple(csr), dim=d,
                         strategy=strategy, overlap=overlap, fused=fused,
                         B=ints(n, d), G=ints(n, d), bias=ints(d),
                         scale=rng.integers(1, 3, n).astype(np.float32)))
    for name, kind, strategy, H, dk, dv in GAT_CASES:
        csr = _graph(kind, 3 if kind == "er_gat" else 7)
        n = csr.n_rows
        lead = (H,) if H > 1 else ()
        draw = lambda d: rng.standard_normal(lead + (n, d)).astype(
            np.float32)
        gat.append(dict(name=name, csr=_csr_tuple(csr), heads=H,
                        strategy=strategy, dim=dk, Q=draw(dk), K=draw(dk),
                        Vf=draw(dv), G=draw(dv)))
    for name, (lg, deg, seed), d, overlap, shard, n_new, thr in \
            REFRESH_CASES:
        csr = _integer(rmat(lg, deg, seed=seed), np.random.default_rng(seed))
        new = _mutated(csr, np.random.default_rng(seed + 1), shard, n_new)
        n = csr.n_rows
        ints = lambda *s: rng.integers(-3, 4, s).astype(np.float32)
        refresh.append(dict(name=name, csr=_csr_tuple(csr),
                            new=_csr_tuple(new), dim=d, overlap=overlap,
                            threshold=thr, B=ints(n, d), G=ints(n, d)))
    return dict(spmm=spmm, gat=gat, refresh=refresh)


# ------------------------------------------- the ranks' side (spawned)
def _rank_ops(inputs, hw, device):
    """Every operator case on this rank, its configs priced at ``hw``
    (None: the default); the global results (``unpad``: every rank holds
    them)."""
    from repro_torch.dist import DistGraph
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(a)
    hw = {} if hw is None else {"hardware": hw}
    out = {}
    for c in inputs["spmm"]:
        g = DistGraph(TCSR(*c["csr"]), c["dim"], P, strategy=c["strategy"],
                      overlap=c["overlap"], device=dev, **hw)
        B = g.pad(t(c["B"])).requires_grad_()
        y = g.spmm(B)
        y.backward(g.pad(t(c["G"])))
        res = {"out": g.unpad(y), "dB": g.unpad(B.grad),
               "configs": [x.astuple() for x in g.configs],
               "shard_nnz": g.shard.csr.nnz}
        if c["fused"]:
            B = g.pad(t(c["B"])).requires_grad_()
            bias = t(c["bias"]).to(dev).requires_grad_()
            y = g.fused(B, scale=g.pad(t(c["scale"])), bias=bias,
                        activation="relu")
            y.backward(g.pad(t(c["G"])))
            res.update(fused=g.unpad(y), fused_dB=g.unpad(B.grad),
                       fused_dbias=g.comm.all_reduce_sum(bias.grad))
        out[c["name"]] = {k: v.cpu() if torch.is_tensor(v) else v
                          for k, v in res.items()}
    for c in inputs["gat"]:
        H = c["heads"]
        g = DistGraph(TCSR(*c["csr"]), c["dim"], P, strategy=c["strategy"],
                      op="gat", heads=H, device=dev, **hw)
        pad = g.pad_heads if H > 1 else g.pad
        unpad = g.unpad_heads if H > 1 else g.unpad
        q, k, v = (pad(t(c[x])).requires_grad_() for x in ("Q", "K", "Vf"))
        y = g.gat_message(q, k, v)
        y.backward(pad(t(c["G"])))
        out[c["name"]] = {"out": unpad(y).cpu(), "dQ": unpad(q.grad).cpu(),
                          "dK": unpad(k.grad).cpu(),
                          "dVf": unpad(v.grad).cpu(),
                          "n_halo": g.shard.n_halo,
                          "shard_nnz": g.shard.csr.nnz}
    return out


def _rank_train():
    """Every training case on this rank: over 2 ranks in two subgroups
    ({0, 1} and {2, 3}), then over all 4."""
    import torch.distributed as dist

    from repro_torch.apps.gnn import train_gnn
    from repro_torch.data.tasks import community_task
    task = community_task(**TRAIN_TASK)
    rank = dist.get_rank()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    out = {}
    for case in TRAIN_CASES:
        model, heads, parts, strategy, overlap, steps, fused = case
        group = pairs[rank // 2] if parts == 2 else None
        res = train_gnn(task, model=model, hidden=32, n_layers=3,
                        steps=steps, heads=heads, partitions=parts,
                        partition_strategy=strategy, overlap=overlap,
                        fused=fused, dist_group=group, device="cpu")
        out[_train_id(case)] = res
    return out


def _rank_obs(inputs, device):
    """One overlap SpMM forward and backward under ``obs.tracing``: the
    spans, the halo byte counter and the priced-overlap gauges."""
    from repro_torch import obs
    from repro_torch.dist import DistGraph
    c = inputs["spmm"][0]
    obs.reset_metrics()
    with obs.tracing():
        g = DistGraph(TCSR(*c["csr"]), c["dim"], P, overlap=True,
                      device=device)
        B = g.pad(torch.as_tensor(c["B"])).requires_grad_()
        g.spmm(B).backward(g.pad(torch.as_tensor(c["G"])))
        spans = sorted({e["name"] for e in obs.trace_events()
                        if e["ph"] == "X"})
        return {"spans": spans, "metrics": obs.metrics_snapshot(),
                "gathered_rows": g.halo.gathered_rows, "dim": c["dim"]}


def _rank_refresh(inputs, hw, device):
    """Every refresh case on this rank: the graph packed and run once,
    ``refresh`` with the mutated graph under tracing, then the SpMM
    forward and backward; what was kept by identity (the rank's pack and
    its device steering), the report and the configs."""
    from repro_torch import obs
    from repro_torch.dist import DistGraph
    from repro_torch.kernels.paramspmm.ops import device_steering
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(a)
    hw = {} if hw is None else {"hardware": hw}
    out = {}
    for c in inputs["refresh"]:
        g = DistGraph(TCSR(*c["csr"]), c["dim"], P, overlap=c["overlap"],
                      device=dev, **hw)
        g.spmm(g.pad(t(c["B"])))
        pack, plan, shards = g.pack, g.halo_plan, list(g.part.shards)
        ops_of = lambda pk: ([pk.loc, pk.halo] if c["overlap"]
                             else [pk.op])
        steers = [device_steering(p, dev) for o in ops_of(pack)
                  for p in (o.pcsr, o.pcsr_t)]
        obs.reset_metrics()
        with obs.tracing():
            rep = g.refresh(TCSR(*c["new"]), threshold=c["threshold"])
            spans = sorted({e["name"] for e in obs.trace_events()
                            if e["ph"] == "X"})
            repacks = obs.metrics_snapshot().get("dist_shard_repacks_total",
                                                 {})
        B = g.pad(t(c["B"])).requires_grad_()
        y = g.spmm(B)
        y.backward(g.pad(t(c["G"])))
        out[c["name"]] = {
            "out": g.unpad(y).cpu(), "dB": g.unpad(B.grad).cpu(),
            "configs": [x.astuple() for x in g.configs],
            "overlap_configs": [(a.astuple(), b.astuple())
                                for a, b in g.overlap_configs],
            "report": _report(rep), "spans": spans,
            "repacks": sum(repacks.values()),
            "shards_kept": [a is b for a, b in zip(g.part.shards, shards)],
            "pack_kept": g.pack is pack,
            "steering_kept": [device_steering(p, dev) is s for s, p in zip(
                steers, [p for o in ops_of(g.pack)
                         for p in (o.pcsr, o.pcsr_t)])],
            "plan_rebuilt": g.halo_plan is not plan,
            "halo_pad": g.part.halo_pad}
    return out


def _report(rep):
    """A ``ShardRefreshReport`` as plain data (either package's)."""
    return {"changed": list(rep.changed), "repicked": list(rep.repicked),
            "reused": list(rep.reused),
            "halo_pad_grew": bool(rep.halo_pad_grew),
            "advisories": {int(p): sorted(a.drifted)
                           for p, a in rep.advisories.items()}}


def _rank_main(path, device, hw):
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    out = {"ops": _rank_ops(inputs, hw, device),
           "refresh": _rank_refresh(inputs, hw, device),
           "obs": _rank_obs(inputs, device)}
    if device == "cpu":
        out["train"] = _rank_train()
    return out


# ------------------------------------------------------- the reference
JAX_SCRIPT = textwrap.dedent('''
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import CSRMatrix
    from repro.dist import DistGraph, dist_gat_message, dist_spmm
    assert jax.device_count() >= 4
    with open(sys.argv[1], "rb") as f:
        inputs = pickle.load(f)
    out = {}
    for c in inputs["spmm"] if sys.argv[3] == "spmm" else ():
        g = DistGraph(CSRMatrix(*c["csr"]), c["dim"], 4,
                      strategy=c["strategy"], overlap=c["overlap"])
        B, G = jnp.asarray(c["B"]), jnp.asarray(c["G"])
        y, vjp = jax.vjp(lambda b: dist_spmm(g, b), B)
        res = {"out": y, "dB": vjp(G)[0]}
        if c["fused"]:
            sc = jnp.asarray(c["scale"])
            y, vjp = jax.vjp(lambda b, bb: g.fused(
                b, scale=sc, bias=bb, activation="relu"),
                B, jnp.asarray(c["bias"]))
            dB, db = vjp(G)
            res.update(fused=y, fused_dB=dB, fused_dbias=db)
        out[c["name"]] = {k: np.asarray(v) for k, v in res.items()}
    for c in inputs["gat"] if sys.argv[3] == "gat" else ():
        g = DistGraph(CSRMatrix(*c["csr"]), c["dim"], 4,
                      strategy=c["strategy"], op="gat", heads=c["heads"])
        ops = [jnp.asarray(c[x]) for x in ("Q", "K", "Vf")]
        y, vjp = jax.vjp(lambda q, k, v: dist_gat_message(g, q, k, v), *ops)
        dq, dk, dv = vjp(jnp.asarray(c["G"]))
        out[c["name"]] = {k: np.asarray(v) for k, v in
                          dict(out=y, dQ=dq, dK=dk, dVf=dv).items()}
    for c in inputs["refresh"] if sys.argv[3] == "spmm" else ():
        g = DistGraph(CSRMatrix(*c["csr"]), c["dim"], 4,
                      overlap=c["overlap"])
        B, G = jnp.asarray(c["B"]), jnp.asarray(c["G"])
        dist_spmm(g, B)
        rep = g.refresh(CSRMatrix(*c["new"]), threshold=c["threshold"])
        y, vjp = jax.vjp(lambda b: dist_spmm(g, b), B)
        out[c["name"]] = {
            "out": np.asarray(y), "dB": np.asarray(vjp(G)[0]),
            "configs": [x.astuple() for x in g.configs],
            "overlap_configs": [(a.astuple(), b.astuple())
                                for a, b in g.overlap_configs],
            "report": {"changed": list(rep.changed),
                       "repicked": list(rep.repicked),
                       "reused": list(rep.reused),
                       "halo_pad_grew": bool(rep.halo_pad_grew),
                       "advisories": {int(p): sorted(a.drifted) for p, a
                                      in rep.advisories.items()}},
            "halo_pad": g.part.halo_pad}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
''')


@pytest.fixture(scope="module")
def inputs_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(_inputs(), f)
    return path


@pytest.fixture(scope="module")
def runs(inputs_path):
    """The reference's 4-device programs (two subprocesses: the SpMM and
    the GAT cases) and the port's 4 gloo ranks, run side by side."""
    from repro_torch.dist import comm
    # one thread each: the module shares the host with the other test
    # workers, some of whose checks are wall-clock gates
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    refs = {kind: subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(inputs_path),
         str(inputs_path.with_name(f"reference_{kind}.pkl")), kind],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for kind in ("spmm", "gat")}
    reference = {}
    try:
        ranks = comm.spawn(_rank_main, P, (str(inputs_path), "cpu",
                                           _ref_hw()),
                           backend="gloo", device="cpu", threads=1)
        for kind, proc in refs.items():
            log, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, log
            with open(inputs_path.with_name(f"reference_{kind}.pkl"),
                      "rb") as f:
                reference.update(pickle.load(f))
    finally:
        for proc in refs.values():
            proc.kill()
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    return inputs, ranks, reference


# ------------------------------------------------------ (a) host plan
PLAN_CASES = [(k, s, n) for k in ("rmat", "er", "grid", "sbm", "random")
              for s in ("contiguous", "balanced") for n in (3, 4)]


@pytest.mark.parametrize("kind,strategy,n_parts", PLAN_CASES,
                         ids=lambda x: str(x))
def test_host_plan_equals_reference(kind, strategy, n_parts):
    from repro import dist as rdist

    from repro_torch import dist as tdist
    t = _graph(kind, seed=3)
    r = _ref(t)
    assert np.array_equal(tdist.partition_bounds(t, n_parts, strategy),
                          rdist.partition_bounds(r, n_parts, strategy))
    rp = rdist.partition_csr(r, n_parts, strategy)
    tpart = tdist.partition_csr(t, n_parts, strategy)
    assert np.array_equal(tpart.starts, rp.starts)
    assert (tpart.rows_pad, tpart.halo_pad) == (rp.rows_pad, rp.halo_pad)
    for a, b in zip(tpart.shards, rp.shards):
        assert (a.part, a.start, a.stop, a.n_halo) == \
            (b.part, b.start, b.stop, b.n_halo)
        assert np.array_equal(a.halo_global, b.halo_global)
        for f in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(a.csr, f), getattr(b.csr, f)), f
        assert a.csr.shape == b.csr.shape
        for x, y in zip(tdist.split_local_halo(a, tpart),
                        rdist.split_local_halo(b, rp)):
            assert x.shape == y.shape
            for f in ("indptr", "indices", "data"):
                assert np.array_equal(getattr(x, f), getattr(y, f)), f
    th, rh = tdist.build_halo(tpart), rdist.build_halo(rp)
    assert (th.n_parts, th.max_send, th.max_halo) == \
        (rh.n_parts, rh.max_send, rh.max_halo)
    for f in ("send_idx", "n_send", "halo_src", "n_halo"):
        a, b = getattr(th, f), getattr(rh, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    stacked = np.arange(n_parts * tpart.rows_pad)
    assert np.array_equal(tdist.unpartition_rows(tpart, stacked),
                          rdist.unpartition_rows(rp, stacked))


@pytest.mark.parametrize("op,heads,overlap", [
    ("spmm", 1, False), ("spmm", 1, True), ("gat", 1, False),
    ("gat", 4, False)])
@pytest.mark.parametrize("kind", ["rmat", "sbm", "random"])
def test_distgraph_configs_equal_reference(kind, op, heads, overlap):
    from repro.dist import DistGraph as RDistGraph

    from repro_torch.dist import DistGraph
    t = _graph(kind, seed=1)
    want = RDistGraph(_ref(t), 32, 4, op=op, heads=heads, overlap=overlap)
    got = DistGraph(t, 32, 4, op=op, heads=heads, overlap=overlap,
                    hardware=_ref_hw())
    assert [c.astuple() for c in got.configs] == \
        [c.astuple() for c in want.configs]
    assert np.allclose(got.predicted_times, want.predicted_times, rtol=1e-6)
    assert [(a.astuple(), b.astuple()) for a, b in got.overlap_configs] == \
        [(a.astuple(), b.astuple()) for a, b in want.overlap_configs]
    # the plan needs no process group; operators do
    assert got.pack is None
    with pytest.raises(RuntimeError, match="process group"):
        got.spmm(torch.zeros(got.part.rows_pad, 32))
    # a refresh needs no process group either: the same graph changes no
    # shard, so the plan keeps every shard as it was
    shards = list(got.part.shards)
    rep = got.refresh(t)
    assert (rep.changed, rep.repicked, rep.reused, rep.halo_pad_grew) == \
        ([], [], list(range(4)), False)
    assert all(a is b for a, b in zip(got.part.shards, shards))
    assert got.pack is None


def test_power_law_shards_pick_different_configs():
    from repro_torch.dist import DistGraph
    from repro_torch.data.graphs import rmat
    g = DistGraph(rmat(10, 8, seed=1), 32, 4, strategy="balanced")
    assert len(set(g.configs)) > 1, [c.astuple() for c in g.configs]


# --------------------------------------------------- (b) the operators
def _spmm_ref_single(c, key):
    """The reference's single-device SpMM (and fused SpMM) on the whole
    graph, forward and gradient."""
    import jax
    import jax.numpy as jnp

    from repro.core import CSRMatrix, CostModel, config_space
    from repro.core.engine import ParamSpMMOperator
    csr = CSRMatrix(*c["csr"])
    cfg, _ = CostModel(csr).best(c["dim"], config_space(c["dim"]))
    op = ParamSpMMOperator(csr, cfg, backend="engine")
    B, G = jnp.asarray(c["B"]), jnp.asarray(c["G"])
    if key == "spmm":
        y, vjp = jax.vjp(op, B)
        return {"out": y, "dB": vjp(G)[0]}
    y, vjp = jax.vjp(lambda b, bb: op.fused(
        b, scale=jnp.asarray(c["scale"]), bias=bb, activation="relu"),
        B, jnp.asarray(c["bias"]))
    dB, db = vjp(G)
    return {"fused": y, "fused_dB": dB, "fused_dbias": db}


def _case(inputs, kind, name):
    return next(c for c in inputs[kind] if c["name"] == name)


@pytest.mark.parametrize("name", [c[0] for c in SPMM_CASES])
def test_dist_spmm_bit_equal_reference(runs, name):
    inputs, ranks, ref = runs
    c = _case(inputs, "spmm", name)
    got = ranks[0]["ops"][name]
    single = _spmm_ref_single(c, "spmm")
    for k in ("out", "dB"):
        assert np.array_equal(got[k].numpy(), ref[name][k]), k
        assert np.array_equal(got[k].numpy(), np.asarray(single[k])), k
    if name.startswith("empty"):
        assert min(r["ops"][name]["shard_nnz"] for r in ranks) == 0


@pytest.mark.parametrize("name", [c[0] for c in SPMM_CASES if c[4]])
def test_dist_fused_bit_equal_reference(runs, name):
    inputs, ranks, ref = runs
    c = _case(inputs, "spmm", name)
    got = ranks[0]["ops"][name]
    single = _spmm_ref_single(c, "fused")
    for k in ("fused", "fused_dB", "fused_dbias"):
        assert np.array_equal(got[k].numpy(), ref[name][k]), k
        assert np.array_equal(got[k].numpy(), np.asarray(single[k])), k


@pytest.mark.parametrize("name", [c[0] for c in GAT_CASES])
def test_dist_gat_matches_reference(runs, name):
    import jax
    import jax.numpy as jnp

    from repro.core import CSRMatrix, CostModel, build_pcsr, config_space
    from repro.core.engine import make_gat_message_fn
    inputs, ranks, ref = runs
    c = _case(inputs, "gat", name)
    got = ranks[0]["ops"][name]
    csr = CSRMatrix(*c["csr"])
    cfg, _ = CostModel(csr).best(c["dim"], config_space(c["dim"]), op="gat",
                                 H=c["heads"])
    fn = make_gat_message_fn(build_pcsr(csr.indptr, csr.indices, csr.data,
                                        csr.n_rows, csr.n_cols, cfg))
    ops = [jnp.asarray(c[x]) for x in ("Q", "K", "Vf")]
    y, vjp = jax.vjp(fn, *ops)
    single = dict(zip(("out", "dQ", "dK", "dVf"),
                      (y, *vjp(jnp.asarray(c["G"])))))
    for k in ("out", "dQ", "dK", "dVf"):
        np.testing.assert_allclose(got[k].numpy(), ref[name][k], **GAT_TOL,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(single[k]),
                                   **GAT_TOL, err_msg=k)
    if name == "er_h2":          # halo-heavy: most sources are remote
        assert max(r["ops"][name]["n_halo"] for r in ranks) > 40
    if name.startswith("empty"):
        assert min(r["ops"][name]["shard_nnz"] for r in ranks) == 0


@pytest.mark.parametrize("name", [c[0] for c in REFRESH_CASES])
def test_dist_refresh_matches_reference(runs, name):
    """``DistGraph.refresh`` on the 4 ranks against the JAX ``DistGraph``'s
    refresh: the same report and configs on every rank, the SpMM forward
    and gradient after it bit-equal to the reference's and to the
    reference's single-device engine on the mutated graph; unchanged
    shards (and on their ranks the pack and its device steering) kept by
    identity, the changed rank's pack rebuilt."""
    inputs, ranks, ref = runs
    c = _case(inputs, "refresh", name)
    got = [r["refresh"][name] for r in ranks]
    want = ref[name]
    single = _spmm_ref_single(dict(c, csr=c["new"]), "spmm")
    for rank, g in enumerate(got):
        assert g["report"] == want["report"], rank
        assert g["configs"] == want["configs"]
        assert g["overlap_configs"] == want["overlap_configs"]
        assert g["halo_pad"] == want["halo_pad"]
        for k in ("out", "dB"):
            assert np.array_equal(g[k].numpy(), want[k]), k
            assert np.array_equal(g[k].numpy(), np.asarray(single[k])), k
        assert "dynamic.shard_repack" in g["spans"]
        assert g["repacks"] == len(want["report"]["changed"])
        assert g["plan_rebuilt"]
        rep = g["report"]
        assert g["shards_kept"] == [p in rep["reused"] for p in range(P)]
        kept = rank in rep["reused"]
        assert g["pack_kept"] == kept
        assert all(g["steering_kept"]) if kept \
            else not any(g["steering_kept"])
    rep = want["report"]
    if name == "refresh_identity":
        assert rep["changed"] == [1] and rep["reused"] == [0, 2, 3]
        assert not rep["halo_pad_grew"] and rep["repicked"] == []
    elif name == "refresh_repick":
        assert rep["changed"] == rep["repicked"] == [0]
        assert list(rep["advisories"]) == [0] and rep["advisories"][0]
    elif name == "refresh_overlap":
        assert rep["changed"] == [3]
    else:
        assert rep["halo_pad_grew"] and rep["changed"] == list(range(P))


def test_shard_drift_equals_reference():
    from repro.dist import DistGraph as RDistGraph
    from repro.dynamic import shard_drift as r_shard_drift

    from repro_torch.data.graphs import rmat
    from repro_torch.dist import DistGraph
    from repro_torch.dynamic import shard_drift
    t = rmat(8, 6, seed=3)
    rg, tg = RDistGraph(_ref(t), 16, P), DistGraph(t, 16, P,
                                                   hardware=_ref_hw())
    assert shard_drift(tg, t) == {} == r_shard_drift(rg, _ref(t))
    new = _mutated(t, np.random.default_rng(4), 2, 6)
    for thr in (None, 1e-6, {"nnz": 1e-6}):
        a, b = shard_drift(tg, new, threshold=thr), r_shard_drift(
            rg, _ref(new), threshold=thr)
        assert list(a) == list(b) == [2]
        assert (a[2] is None) == (b[2] is None)
        if b[2] is not None:
            assert sorted(a[2].drifted) == sorted(b[2].drifted)
            assert a[2].message == b[2].message
    assert shard_drift(tg, new, threshold=1e-6)[2].drifted
    with pytest.raises(ValueError, match="fixed node set"):
        tg.refresh(rmat(7, 6, seed=1))


def test_every_rank_holds_the_same_results(runs):
    _, ranks, _ = runs
    for name, got in ranks[0]["ops"].items():
        for other in ranks[1:]:
            for k, v in got.items():
                if torch.is_tensor(v):
                    assert torch.equal(v, other["ops"][name][k]), (name, k)
                elif k == "configs":
                    assert v == other["ops"][name][k]


def test_dist_spans_counters_and_gauges(runs):
    _, ranks, _ = runs
    got = ranks[0]["obs"]
    assert {"dist.select_configs", "dist.pack"} <= set(got["spans"])
    m = got["metrics"]
    # one exchange each way, counted per call: the (P·max_send, d) buffer
    nbytes = float(got["gathered_rows"] * got["dim"] * 4)
    assert m["halo_exchange_bytes_total"] == {"direction=gather": nbytes,
                                              "direction=scatter": nbytes}
    assert set(m["halo_exchange_priced_seconds"]) == {""}
    for name in ("overlap_exposed_seconds", "overlap_serialized_seconds"):
        assert set(m[name]) == {f"shard={i}" for i in range(P)}
    for i in range(P):
        key = f"shard={i}"
        assert m["overlap_exposed_seconds"][key] <= \
            m["overlap_serialized_seconds"][key]


# ------------------------------------------------------ (c) training
@pytest.fixture(scope="module")
def single_device():
    """The port's single-device CPU training, reorder off, per model."""
    from repro_torch.apps.gnn import train_gnn
    from repro_torch.data.tasks import community_task
    task = community_task(**TRAIN_TASK)
    out = {}
    for model, heads, _, _, _, steps, fused in TRAIN_CASES:
        key = (model, heads, steps, fused)
        if key not in out:
            out[key] = train_gnn(task, model=model, hidden=32, n_layers=3,
                                 steps=steps, heads=heads, fused=fused,
                                 device="cpu",
                                 spmm_kwargs={"reorder": False})
    return out


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_train_id)
def test_partitioned_training_matches_single_device(runs, single_device,
                                                    case):
    model, heads, parts, _, _, steps, fused = case
    _, ranks, _ = runs
    want = single_device[(model, heads, steps, fused)]
    res = [r["train"][_train_id(case)] for r in ranks]
    got = res[0]
    assert isinstance(got.config, list) and len(got.config) == parts
    a, b = np.array(got.losses), np.array(want.losses)
    if heads > 1:
        np.testing.assert_allclose(a[:MH_HELD_STEPS], b[:MH_HELD_STEPS],
                                   rtol=RTOL)
        np.testing.assert_allclose(a, b, rtol=MH_RTOL)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL)
    assert got.val_acc == want.val_acc
    assert got.losses[-1] < got.losses[0]
    # every rank of the group: the same losses and parameters, bit for bit
    group = res[:parts]
    for other in group[1:]:
        assert other.losses == got.losses and other.val_acc == got.val_acc
        for la, lb in zip(got.params, other.params):
            assert all(torch.equal(la[k], lb[k]) for k in la)
    if parts == 2:             # the second pair trained the same
        assert res[2].losses == got.losses


# --------------------------------------------- (d) backend and device
def test_backend_and_device_choice(monkeypatch):
    from repro_torch.apps.gnn import train_gnn
    from repro_torch.data.tasks import community_task
    from repro_torch.dist import comm
    assert comm.default_backend("cpu") == "gloo"
    assert comm.default_backend("cuda") == "nccl"
    assert comm.rank_device("cpu", 3, "gloo") == torch.device("cpu")
    with pytest.raises(ValueError, match="nccl runs on CUDA"):
        comm.check_world("cpu", 2, "nccl")
    with pytest.raises(ValueError, match="backend must be"):
        comm.check_world("cpu", 2, "mpi")
    task = community_task(n_blocks=2, block_size=16)
    # without a card, CUDA raises rather than falling back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gnn(task, steps=1, partitions=2)
    # one card: NCCL refuses two ranks; gloo shares cuda:0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        comm.check_world("cuda", 2, "nccl")
    with pytest.raises(ValueError, match="backend='gloo'"):
        train_gnn(task, steps=1, partitions=2, device="cuda")
    comm.check_world("cuda", 4, "gloo")
    comm.check_world("cuda", 1, "nccl")
    assert [comm.rank_device("cuda", r, "gloo") for r in range(4)] == \
        [torch.device("cuda", 0)] * 4
    assert comm.rank_device("cuda", 0, "nccl") == torch.device("cuda", 0)
    assert comm.rank_device("cuda:0", 2, "gloo") == torch.device("cuda", 0)


def test_distgraph_refuses_a_mesh_and_unknown_backends():
    from repro_torch.data.graphs import er
    from repro_torch.dist import DistGraph
    g = er(64, 4, seed=0)
    with pytest.raises(ValueError, match="no mesh"):
        DistGraph(g, 8, 2, mesh=object())
    with pytest.raises(ValueError, match="backend must be"):
        DistGraph(g, 8, 2, backend="xla")


@pytest.mark.parametrize("kind", ["rmat", "er"])
def test_overlap_pack_builds_the_whole_shard_at_first_use(kind):
    """Under overlap the SpMM paths read the local and halo packs only;
    the whole shard matrix (the GAT message's) is packed at its first
    use, and equals the two parts summed (bit-equal on integers)."""
    from repro_torch.dist import DistGraph, pack_shard
    rng = np.random.default_rng(5)
    g = DistGraph(_integer(_graph(kind), rng), 8, P, overlap=True)
    rows_pad, width = g.part.rows_pad, g.part.rows_pad + g.halo.max_halo
    for r in range(P):
        pack = pack_shard(g.part.shards[r].csr, g.configs[r], "cpu",
                          split=g._split_csrs[r],
                          split_configs=g.overlap_configs[r])
        assert pack._op is None
        B = torch.tensor(rng.integers(-3, 4, (width, 8)),
                         dtype=torch.float32)
        parts = pack.loc(B[:rows_pad]) + pack.halo(B[rows_pad:])
        assert torch.equal(pack.op(B), parts)
        assert pack._op is pack.op


def test_priced_exchange_uses_the_nvlink_data_sheet_rate():
    from repro_torch.core import cost_model as cm
    assert cm.NVLINK_BW == 450e9
    t = cm.halo_exchange_cost(4 * 1000, 64)
    assert t == pytest.approx(4000 * 64 * 4 / 450e9)
    assert cm.overlap_exposed_cost(2.0, 1.0, 3.0) == 4.0
    assert cm.overlap_exposed_cost(3.0, 1.0, 2.0) == 4.0


# ------------------------------------------------------ on the card
@pytest.fixture(scope="module")
def card_runs(inputs_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.dist import comm
    from repro_torch.kernels import build
    build.build()
    return comm.spawn(_rank_main, P, (str(inputs_path), "cuda", None),
                      backend="gloo", device="cuda", threads=1)


def _single_on_card(c, kind):
    """The single-device kernels on the card, on the whole graph."""
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.engine import ParamSpMMOperator, \
        make_gat_message_fn
    from repro_torch.core.pcsr import config_space
    csr = TCSR(*c["csr"])
    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(a, device=dev)
    if kind == "gat":
        cfg, _ = CostModel(csr).best(c["dim"], config_space(c["dim"]),
                                     op="gat", H=c["heads"])
        op = ParamSpMMOperator(csr, cfg, device=dev)
        fn = make_gat_message_fn(op.pcsr, op.pcsr_t)
        q, k, v = (t(c[x]).requires_grad_() for x in ("Q", "K", "Vf"))
        y = fn(q, k, v)
        y.backward(t(c["G"]))
        return {"out": y, "dQ": q.grad, "dK": k.grad, "dVf": v.grad}
    cfg, _ = CostModel(csr).best(c["dim"], config_space(c["dim"]))
    op = ParamSpMMOperator(csr, cfg, device=dev)
    B = t(c["B"]).requires_grad_()
    y = op(B)
    y.backward(t(c["G"]))
    out = {"out": y, "dB": B.grad}
    if c["fused"]:
        B = t(c["B"]).requires_grad_()
        bias = t(c["bias"]).requires_grad_()
        y = op.fused(B, scale=t(c["scale"]), bias=bias, activation="relu")
        y.backward(t(c["G"]))
        out.update(fused=y, fused_dB=B.grad, fused_dbias=bias.grad)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in SPMM_CASES + GAT_CASES])
def test_dist_operators_on_card(card_runs, inputs_path, name):
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    kind = "gat" if any(c[0] == name for c in GAT_CASES) else "spmm"
    want = _single_on_card(_case(inputs, kind, name), kind)
    got = card_runs[0]["ops"][name]
    for k, v in want.items():
        v = v.detach().cpu()
        if kind == "spmm":
            assert torch.equal(got[k], v), k
        else:
            torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-4)
