"""PyTorch port vs JAX reference: dynamic graphs (``repro_torch.dynamic``).

Each case of ``tests/test_dynamic.py`` runs here with the same seeded
mutation stream through both packages:

* the layout arrays and the kernel-facing view — ``colidx``, ``lrow``,
  ``trow``, ``init``, ``vals``, ``nnz``, ``nnz_vec``,
  ``n_nonempty_blocks``, ``num_chunks`` — and ``to_csr`` are array-equal
  after every batch (down to which free slot each insert claims);
* SpMM over a degraded view (the port's plain version on the CPU) is
  bit-exact on integer operands against the reference's engine on the
  same view and against a fresh pack of the mutated edges, forward and
  gradient;
* the GAT message over a degraded view (rows that lost every edge
  included, 1 and 4 heads) within ``rtol=1e-5, atol=1e-5`` of the
  reference's engine and of a fresh pack, forward and gradients;
* the governor's verdicts (action, config, priced seconds) equal the
  reference's under its constants (``REF_HW`` and ``REF_PACK``).

The kernels over degraded views on the card, against their plain
versions, are ``cuda``-marked cases of ``tests/test_torch_cuda.py``
(which imports no JAX, so they run on the card's machine).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _propcheck as pc

import repro.core.cost_model as rcm
from repro import obs as robs
from repro.core import CostModel as RCostModel
from repro.core import CSRMatrix as RCSR
from repro.core import build_pcsr as r_build
from repro.core import config_space as r_space
from repro.core.engine import engine_spmm as r_engine_spmm
from repro.core.engine import make_gat_message_fn as r_gat_fn
from repro.core.engine import make_spmm_fn as r_spmm_fn
from repro.core.pcsr import SpMMConfig as RCfg
from repro.dynamic import DynamicGraph as RGraph
from repro.dynamic import DynamicPCSR as RDyn
from repro.dynamic import RepackGovernor as RGov

from repro_torch import obs as tobs
from repro_torch.core import cost_model as tcm
from repro_torch.core import pcsr as tp
from repro_torch.core.engine import make_gat_message_fn as t_gat_fn
from repro_torch.core.sparse import CSRMatrix as TCSR
from repro_torch.dynamic import DynamicGraph as TGraph
from repro_torch.dynamic import DynamicPCSR as TDyn
from repro_torch.dynamic import RepackGovernor as TGov
from repro_torch.kernels.paramspmm.ops import paramspmm

from test_torch_pcsr import REF_HW

REF_PACK = tcm.PackSetup(fixed=rcm.PACK_SETUP,
                         per_nnz=rcm.PACK_SETUP_PER_NNZ)
GAT_TOL = dict(rtol=1e-5, atol=1e-5)
VIEW_FIELDS = ("colidx", "lrow", "trow", "init", "vals")
VIEW_STATS = ("nnz", "nnz_vec", "n_nonempty_blocks", "num_chunks", "K",
              "n_blocks", "n_rows", "n_cols")
DYN_STATS = ("nnz", "nnz_vec", "num_chunks", "n_visited_blocks",
             "n_nonempty_blocks", "n_slack_inserts", "n_delta_chunks",
             "n_tombstones", "version", "base_num_chunks")


@pytest.fixture(autouse=True)
def _clean_obs():
    for o in (robs, tobs):
        if o.trace_enabled():                          # pragma: no cover
            o.stop_tracing()
        o.reset_metrics()
        o.clear_decisions()
    yield
    for o in (robs, tobs):
        if o.trace_enabled():
            o.stop_tracing()
        o.reset_metrics()
        o.clear_decisions()


# ------------------------------------------------------------ helpers
def _int_csr(rng, n, density=0.12):
    """Integer-valued adjacency (order-independent float32 sums) in both
    packages."""
    A = ((rng.random((n, n)) < density)
         * rng.integers(1, 8, (n, n))).astype(np.float32)
    r = RCSR.from_dense(A)
    return r, _t(r)


def _t(r):
    return TCSR(r.indptr.copy(), r.indices.copy(), r.data.copy(),
                r.n_rows, r.n_cols)


def _tcfg(c):
    return tp.SpMMConfig(V=c.V, S=c.S, F=c.F, W=c.W, B=c.B)


def _int_feats(rng, n, d):
    return rng.integers(-3, 4, (n, d)).astype(np.float32)


def _edges_of(csr):
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64), csr.degrees)
    return rows, csr.indices


def _both(rcsr, tcsr, cfg):
    return RDyn.from_csr(rcsr, cfg), TDyn.from_csr(tcsr, _tcfg(cfg))


def _same_csr(r, t):
    assert (r.n_rows, r.n_cols) == (t.n_rows, t.n_cols)
    for f in ("indptr", "indices", "data"):
        a, b = getattr(r, f), getattr(t, f)
        assert np.array_equal(a, b), f


def _same_layout(rd, td):
    """The two packages' layouts are array-equal: the view, the live
    stats, the edge set."""
    for f in DYN_STATS:
        assert getattr(td, f) == getattr(rd, f), f
    assert td.config.astuple() == rd.config.astuple()
    rv, tv = rd.pcsr, td.pcsr
    for f in VIEW_FIELDS:
        a, b = getattr(rv, f), getattr(tv, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in VIEW_STATS:
        assert getattr(tv, f) == getattr(rv, f), f
    assert tv.config.astuple() == rv.config.astuple()
    assert td.slot_fill == rd.slot_fill
    assert td.padding_ratio == rd.padding_ratio
    _same_csr(rd.to_csr(), td.to_csr())


def _mutate_both(rng, rd, td, n, step):
    """One randomized batch — insert, delete or full re-pack — drawn once
    and applied to both packages."""
    op = int(rng.integers(0, 4))
    if op == 3 and step > 0:
        rd.repack()
        td.repack()
        return
    if op == 2 and rd.nnz:
        rows, cols = _edges_of(rd.to_csr())
        m = min(int(rng.integers(1, 16)), rows.size)
        pick = rng.choice(rows.size, size=m, replace=False)
        a = rd.delete_edges(rows[pick], cols[pick])
        b = td.delete_edges(rows[pick], cols[pick])
        assert vars(a) == vars(b)
        return
    m = int(rng.integers(1, 24))
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    v = rng.integers(1, 8, m).astype(np.float32)
    assert vars(rd.insert_edges(r, c, v)) == vars(td.insert_edges(r, c, v))


def _r_spmm(view, B):
    return np.asarray(r_engine_spmm(view, jnp.asarray(B)))


def _t_spmm(view, B):
    return paramspmm(view, torch.as_tensor(B)).numpy()


def _t_fresh(csr, cfg, B):
    p = tp.build_pcsr(csr.indptr, csr.indices, csr.data, csr.n_rows,
                      csr.n_cols, _tcfg(cfg) if isinstance(cfg, RCfg)
                      else cfg)
    return _t_spmm(p, B)


def _spmm_all_agree(rd, td, cfg, B):
    """The degraded view's SpMM: port == reference engine == a fresh
    port pack of the mutated edges, bit for bit."""
    got = _t_spmm(td.pcsr, B)
    assert np.array_equal(got, _r_spmm(rd.pcsr, B))
    assert np.array_equal(got, _t_fresh(td.to_csr(), cfg, B))
    return got


# ----------------------------------------------- bit-exact mutation stream
@pytest.mark.parametrize("case", pc.propcases(
    5, n=pc.integers(16, 48), density=pc.floats(0.04, 0.2),
    v=pc.sampled_from([1, 2]), s=pc.booleans(), b=pc.booleans(),
    seed=pc.integers(0, 99)), ids=str)
def test_mutation_stream_layout_and_spmm_equal_reference(case):
    """After any randomized insert/delete/re-pack stream the port's layout
    is array-equal to the reference's, and its SpMM is bit-identical to
    the reference's engine on the same view and to a fresh pack."""
    rng = np.random.default_rng(case.seed)
    rcsr, tcsr = _int_csr(rng, case.n, case.density)
    cfg = RCfg(V=case.v, S=case.s, W=8 // case.v, B=case.b and case.s)
    rd, td = _both(rcsr, tcsr, cfg)
    _same_layout(rd, td)
    B = _int_feats(rng, case.n, 9)
    for step in range(7):
        _mutate_both(rng, rd, td, case.n, step)
        _same_layout(rd, td)
        trow = td.pcsr.trow            # each block's chunks contiguous
        assert int((np.diff(trow) != 0).sum()) == len(set(trow.tolist())) - 1
        _spmm_all_agree(rd, td, cfg, B)


def test_empty_block_birth_and_death(rng):
    n = 64
    A = np.zeros((n, n), np.float32)
    A[:16] = (rng.random((16, n)) < 0.3) * rng.integers(1, 5, (16, n))
    rcsr = RCSR.from_dense(A.astype(np.float32))
    cfg = RCfg(V=2, S=True, W=4)
    rd, td = _both(rcsr, _t(rcsr), cfg)
    blocks0 = td.n_visited_blocks
    B = _int_feats(rng, n, 8)
    # birth: rows 40..47 live in blocks nothing targeted at pack time
    for d in (rd, td):
        d.insert_edges([40, 41, 47], [3, 9, 60], [2.0, 3.0, 1.0])
    assert td.n_visited_blocks > blocks0 and td.n_delta_chunks >= 1
    _same_layout(rd, td)
    _spmm_all_agree(rd, td, cfg, B)
    # death: every edge of row band 0..7 (its block empties)
    rows, cols = _edges_of(rd.to_csr())
    sel = rows < 8
    for d in (rd, td):
        d.delete_edges(rows[sel], cols[sel])
    _same_layout(rd, td)
    out = _spmm_all_agree(rd, td, cfg, B)
    assert (out[:8] == 0).all()
    assert td.to_csr().nnz == td.nnz
    fresh_r, fresh_t = rd.repack(), td.repack()
    assert fresh_t.n_rows == fresh_r.n_rows == n
    _same_layout(rd, td)
    _spmm_all_agree(rd, td, cfg, B)


def test_fat_row_growth_spills_into_delta_chunks(rng):
    n = 48
    rcsr, tcsr = _int_csr(rng, n, 0.05)
    cfg = RCfg(V=1, S=True, W=8)
    rd, td = _both(rcsr, tcsr, cfg)
    chunks0, B = td.num_chunks, _int_feats(rng, n, 6)
    cols = rng.permutation(n)[:40]
    vals = rng.integers(1, 6, 40).astype(np.float32)
    for d in (rd, td):
        d.insert_edges(np.full(40, 3), cols, vals)
    assert td.n_delta_chunks > 0 and td.num_chunks > chunks0
    _same_layout(rd, td)
    _spmm_all_agree(rd, td, cfg, B)


def test_spmm_gradient_on_degraded_layout(rng):
    """``DynamicGraph.spmm``'s backward runs on a transpose pack of the
    degraded view, built at the first backward: bit-exact against the
    reference's gradient through a fresh pack and its transpose."""
    n = 40
    rcsr, tcsr = _int_csr(rng, n, 0.1)
    g = TGraph(tcsr, 8, config=tp.SpMMConfig(V=2, S=True, W=4),
               auto_heal=False, device="cpu")
    rd = RDyn.from_csr(rcsr, RCfg(V=2, S=True, W=4))
    for _ in range(4):
        _mutate_both(rng, rd, g.dyn, n, 0)
    _same_layout(rd, g.dyn)
    B, G = _int_feats(rng, n, 8), _int_feats(rng, n, 8)
    Bt = torch.as_tensor(B).requires_grad_()
    out = g.spmm(Bt)
    out.backward(torch.as_tensor(G))
    cur = rd.to_csr()
    cfg = rd.config
    p = r_build(cur.indptr, cur.indices, cur.data, n, n, cfg)
    t = cur.transpose()
    pt = r_build(t.indptr, t.indices, t.data, n, n, cfg)
    y, vjp = jax.vjp(r_spmm_fn(p, pt), jnp.asarray(B))
    assert np.array_equal(out.detach().numpy(), np.asarray(y))
    assert np.array_equal(Bt.grad.numpy(), np.asarray(vjp(jnp.asarray(G))[0]))


def _gat_stream(rng, n, cfg):
    """A degraded layout with a row that lost every edge: four random
    batches (no re-pack) and then every edge of row 5 deleted."""
    rcsr, tcsr = _int_csr(rng, n, 0.1)
    rd, td = _both(rcsr, tcsr, cfg)
    for _ in range(4):
        _mutate_both(rng, rd, td, n, 0)
    rows, cols = _edges_of(rd.to_csr())
    sel = rows == 5
    assert vars(rd.delete_edges(rows[sel], cols[sel])) == \
        vars(td.delete_edges(rows[sel], cols[sel]))
    assert td.n_slack_inserts + td.n_delta_chunks + td.n_tombstones > 0
    assert td.to_csr().degrees[5] == 0
    _same_layout(rd, td)
    return rd, td


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_exact_on_degraded_layout(rng, heads):
    """The GAT message over a degraded view (tombstoned cells, delta
    chunks, a row without edges) matches the reference's engine on the
    same view and the port over a fresh pack, forward and gradients."""
    n = 40
    cfg = RCfg(V=2, S=True, W=4)
    rd, td = _gat_stream(rng, n, cfg)
    lead = (heads,) if heads > 1 else ()
    draw = lambda d: rng.standard_normal(lead + (n, d)).astype(np.float32)
    Q, K, Vf, G = draw(8), draw(8), draw(5), draw(5)
    cur = td.to_csr()
    fresh = tp.build_pcsr(cur.indptr, cur.indices, cur.data, n, n,
                          _tcfg(cfg))
    got = []
    for p in (td.pcsr, fresh):
        ts = [torch.as_tensor(x).requires_grad_() for x in (Q, K, Vf)]
        y = t_gat_fn(p)(*ts)
        y.backward(torch.as_tensor(G))
        got.append([y.detach().numpy()] + [x.grad.numpy() for x in ts])
    fn = r_gat_fn(rd.pcsr, backend="engine")
    if heads > 1:
        fn = jax.vmap(fn)
    y, vjp = jax.vjp(fn, *map(jnp.asarray, (Q, K, Vf)))
    want = [np.asarray(y)] + [np.asarray(x) for x in vjp(jnp.asarray(G))]
    for a, b, w in zip(*got, want):
        np.testing.assert_allclose(a, w, **GAT_TOL)
        np.testing.assert_allclose(a, b, **GAT_TOL)
    assert np.isfinite(got[0][0]).all()
    assert (got[0][0][..., 5, :] == 0).all()       # the row without edges


# ------------------------------------------------------ API contracts
def test_insert_rejects_zero_values_and_out_of_range(rng):
    rcsr, tcsr = _int_csr(rng, 16)
    for d in _both(rcsr, tcsr, RCfg(V=1, S=False, W=8)):
        with pytest.raises(ValueError, match="value exactly 0"):
            d.insert_edges([1], [2], [0.0])
        with pytest.raises(ValueError, match="fixed node set"):
            d.insert_edges([16], [2], [1.0])
        with pytest.raises(ValueError, match="match in length"):
            d.insert_edges([1, 2], [3], [1.0])


def test_delete_missing_is_counted_not_raised(rng):
    rcsr, tcsr = _int_csr(rng, 16)
    rd, td = _both(rcsr, tcsr, RCfg(V=1, S=False, W=8))
    a, b = rd.delete_edges([0, 1], [0, 1]), td.delete_edges([0, 1], [0, 1])
    assert vars(a) == vars(b) and b.missing + b.deleted == 2
    v0 = td.version
    b2 = td.delete_edges([0], [0])
    assert vars(rd.delete_edges([0], [0])) == vars(b2)
    assert b2.missing == 1 and b2.deleted == 0
    assert td.version == v0 == rd.version
    _same_layout(rd, td)


def test_mutation_report_counts_slack_vs_delta(rng):
    rcsr, tcsr = _int_csr(rng, 32, 0.08)
    rd, td = _both(rcsr, tcsr, RCfg(V=2, S=True, W=4))
    m = 30
    rng2 = np.random.default_rng(7)
    args = (rng2.integers(0, 32, m), rng2.integers(0, 32, m),
            rng2.integers(1, 5, m).astype(np.float32))
    a, b = rd.insert_edges(*args), td.insert_edges(*args)
    assert vars(a) == vars(b)
    assert b.inserted + b.updated == m
    assert b.slack_inserts == td.n_slack_inserts
    assert b.delta_chunks == td.n_delta_chunks
    rows, cols = _edges_of(td.to_csr())
    upd = (rows[:5], cols[:5], np.full(5, 7.0, np.float32))
    a2, b2 = rd.insert_edges(*upd), td.insert_edges(*upd)
    assert vars(a2) == vars(b2)
    assert b2.updated == 5 and b2.slack_inserts == 0
    _same_layout(rd, td)


def test_reselect_only_changes_f(rng):
    rcsr, tcsr = _int_csr(rng, 32, 0.1)
    cfg = RCfg(V=2, S=True, W=4, F=1)
    rd, td = _both(rcsr, tcsr, cfg)
    with pytest.raises(ValueError, match="only change F"):
        td.reselect(tp.SpMMConfig(V=1, S=True, W=8, F=1))
    with pytest.raises(ValueError, match="only change F"):
        td.reselect(tp.SpMMConfig(V=2, S=False, W=4, F=1))
    v0 = td.version
    rd.reselect(RCfg(V=2, S=True, W=4, F=2))
    td.reselect(tp.SpMMConfig(V=2, S=True, W=4, F=2))
    assert td.config.F == 2 and td.version == v0 + 1
    assert td.pcsr.config.F == 2
    _same_layout(rd, td)
    _spmm_all_agree(rd, td, cfg, _int_feats(rng, 32, 9))


def test_repack_clears_layout_debt(rng):
    rcsr, tcsr = _int_csr(rng, 40, 0.1)
    rd, td = _both(rcsr, tcsr, RCfg(V=2, S=True, W=4))
    for _ in range(3):
        _mutate_both(rng, rd, td, 40, 0)
    v0 = td.version
    fr, ft = rd.repack(), td.repack()
    assert td.version == v0 + 1
    assert td.n_delta_chunks == 0 and td.n_tombstones == 0
    for f in VIEW_FIELDS:
        assert np.array_equal(getattr(fr, f), getattr(ft, f)), f
    _same_layout(rd, td)
    fresh = TDyn.from_csr(td.to_csr(), td.config)
    assert td.num_chunks == fresh.num_chunks


# -------------------------------------------------- governor + pricing
def test_degraded_cost_equals_reference_and_fresh_cost(rng):
    """Under the reference's constants the port prices the degraded grid
    exactly as the reference does; on an unmutated layout it agrees with
    ``kernel_cost``; degradation raises the price; the re-pack price is
    the reference's at the reference's constants."""
    rcsr, tcsr = _int_csr(rng, 64, 0.1)
    cfg = RCfg(V=2, S=True, W=4)
    rd, td = _both(rcsr, tcsr, cfg)

    def priced(d, **kw):
        r = rcm.degraded_kernel_cost(32, cfg, C=d.num_chunks, K=d.K,
                                     n_blocks_visited=d.n_visited_blocks,
                                     **kw)
        t = tcm.degraded_kernel_cost(32, _tcfg(cfg), C=d.num_chunks, K=d.K,
                                     n_blocks_visited=d.n_visited_blocks,
                                     hw=REF_HW, **kw)
        assert vars(t) == vars(r)
        return t
    st = tp.pcsr_stats(tcsr.indptr, tcsr.indices, 64, 64, cfg.V, cfg.W)
    fresh = tcm.kernel_cost(st, 32, _tcfg(cfg), REF_HW)
    b = priced(td)
    assert b.steps == fresh.steps and b.total == pytest.approx(fresh.total)
    for kw in ({"heads": 4}, {"epilogue": True, "residual": True}):
        priced(td, **kw)
    for d in (rd, td):
        d.insert_edges(np.full(30, 1), np.arange(30),
                       np.ones(30, np.float32))
    assert priced(td).total >= b.total
    for nnz in (0, 5, 2_942_342):
        assert tcm.pack_setup_seconds(nnz, REF_PACK) == \
            rcm.pack_setup_seconds(nnz)
    assert tcm.pack_setup_seconds(10 ** 6, REF_PACK) > \
        tcm.pack_setup_seconds(0, REF_PACK) > 0
    # the default is the card's fit: a re-pack's price grows with nnz
    fit = tcm.PACK_SETUP_H100
    assert fit.per_nnz > 0 and fit.fixed >= 0
    assert tcm.pack_setup_seconds(10 ** 6) == fit.fixed + fit.per_nnz * 1e6


def _decisions_equal(rg, tg):
    assert len(rg.decisions) == len(tg.decisions)
    for a, b in zip(rg.decisions, tg.decisions):
        assert (b.action, b.config.astuple()) == (a.action, a.config.astuple())
        assert (b.degraded_seconds, b.fresh_seconds,
                b.repack_amortized_seconds) == \
            (a.degraded_seconds, a.fresh_seconds,
             a.repack_amortized_seconds)
        assert b.reason == a.reason
        assert (b.advisory is None) == (a.advisory is None)
        if a.advisory is not None:
            assert sorted(b.advisory.drifted) == sorted(a.advisory.drifted)


def _graphs(rcsr, tcsr, dim, **kw):
    return (RGraph(rcsr, dim, **kw),
            TGraph(tcsr, dim, hardware=REF_HW, pack_setup=REF_PACK,
                   device="cpu", **kw))


def _churn_both(rng, rg, tg, n, m_ins, m_del):
    r, c = rng.integers(0, n, m_ins), rng.integers(0, n, m_ins)
    v = rng.integers(1, 5, m_ins).astype(np.float32)
    for g in (rg, tg):
        g.insert_edges(r, c, v)
    rows, cols = _edges_of(rg.dyn.to_csr())
    pick = rng.choice(rows.size, size=min(m_del, rows.size), replace=False)
    for g in (rg, tg):
        g.delete_edges(rows[pick], cols[pick])


def test_governor_auto_repack_under_churn_with_counters(rng):
    """The churn stream degrades the layout until the priced gap exceeds
    slack and the governor re-packs: the port's verdicts equal the
    reference's one for one, the counters and decision log agree, and
    every SpMM along the way is bit-exact."""
    n = 96
    rcsr, tcsr = _int_csr(rng, n, 0.06)
    B = _int_feats(rng, n, 16)
    with robs.tracing(), tobs.tracing():
        rg, tg = _graphs(rcsr, tcsr, 16, slack=1.05, amortize_steps=10)
        assert tg.config.astuple() == rg.config.astuple()
        for _ in range(6):
            _churn_both(rng, rg, tg, n, 150, 140)
            _same_layout(rg.dyn, tg.dyn)
            got = tg.spmm(torch.as_tensor(B)).numpy()
            assert np.array_equal(got, np.asarray(rg.spmm(jnp.asarray(B))))
            assert np.array_equal(got, _t_fresh(tg.dyn.to_csr(), tg.config,
                                                B))
        _decisions_equal(rg, tg)
        actions = [d.action for d in tg.decisions]
        assert "repack" in actions, actions
        rs, ts = robs.metrics_snapshot(), tobs.metrics_snapshot()
        for name in ("dynamic_repacks_total", "governor_decisions_total",
                     "dynamic_mutations_total", "dynamic_slack_inserts_total",
                     "dynamic_delta_chunks_total", "dynamic_tombstones_total",
                     "drift_advisories_total"):
            assert ts.get(name) == rs.get(name), name
        assert sum(ts["governor_decisions_total"].values()) == len(actions)
        rlog = [d for d in robs.decision_log() if d.source == "governor"]
        tlog = [d for d in tobs.decision_log() if d.source == "governor"]
        assert [d.snapshot for d in tlog] == [d.snapshot for d in rlog]
        assert any(d.snapshot["action"] == "repack" for d in tlog)
        names = {e["name"] for e in tobs.trace_events()}
        assert {"governor_decision", "dynamic.repack"} <= names
    # after a re-pack the governor is rebaselined: an untouched graph idles
    assert tg.governor.evaluate(tg.dyn, tg.config).action == "none"


def test_governor_advisory_only_when_auto_heal_off(rng):
    n = 64
    rcsr, tcsr = _int_csr(rng, n, 0.06)
    rg, tg = _graphs(rcsr, tcsr, 16, slack=1.0, amortize_steps=1000,
                     auto_heal=False)
    for _ in range(3):
        _churn_both(rng, rg, tg, n, 120, 110)
    _decisions_equal(rg, tg)
    assert any(d.action == "repack" for d in tg.decisions)
    assert tg.dyn.n_tombstones + tg.dyn.n_delta_chunks \
        + tg.dyn.n_slack_inserts > 0
    _same_layout(rg.dyn, tg.dyn)
    B = _int_feats(rng, n, 16)
    assert rg.repack().astuple() == tg.repack().astuple()
    assert tg.dyn.n_tombstones == 0 and tg.dyn.n_delta_chunks == 0
    _same_layout(rg.dyn, tg.dyn)
    assert np.array_equal(tg.spmm(torch.as_tensor(B)).numpy(),
                          _t_fresh(tg.dyn.to_csr(), tg.config, B))


def test_governor_fast_path_and_threshold_plumbing(rng):
    rcsr, tcsr = _int_csr(rng, 48, 0.1)
    cfg, _ = RCostModel(rcsr).best(16, r_space(16))
    tcfg, _ = tcm.CostModel(tcsr, REF_HW).best(16, tp.config_space(16))
    assert tcfg.astuple() == cfg.astuple()
    rd, td = _both(rcsr, tcsr, cfg)
    rgov = RGov(16, slack=1.25, amortize_steps=100,
                drift_threshold={"nnz": 10.0})
    tgov = TGov(16, slack=1.25, amortize_steps=100,
                drift_threshold={"nnz": 10.0}, hardware=REF_HW,
                pack_setup=REF_PACK)
    rgov.rebaseline(rd, cfg)
    tgov.rebaseline(td, tcfg)
    for step in range(2):
        if step:
            for d in (rd, td):
                d.insert_edges([0], [1], [1.0])
        a, b = rgov.evaluate(rd, cfg), tgov.evaluate(td, tcfg)
        assert b.action == a.action == "none" and b.advisory is None
        assert (b.degraded_seconds, b.fresh_seconds) == \
            (a.degraded_seconds, a.fresh_seconds)


def test_dynamic_graph_versioned_operator_rebuild(rng):
    """Operators close over one version's view and steering: rebuilt when
    (and only when) the version moves."""
    n = 32
    rcsr, tcsr = _int_csr(rng, n, 0.1)
    rg, tg = _graphs(rcsr, tcsr, 8, auto_heal=False)
    B = _int_feats(rng, n, 8)
    out0 = tg.spmm(torch.as_tensor(B)).numpy()
    fn0, view0 = tg._spmm_fn, tg.dyn.pcsr
    tg.spmm(B)                                  # numpy operands too
    assert tg._spmm_fn is fn0 and tg.dyn.pcsr is view0
    for g in (rg, tg):
        g.insert_edges([0], [n - 1], [3.0])
    out1 = tg.spmm(torch.as_tensor(B)).numpy()
    assert tg._spmm_fn is not fn0 and tg.dyn.pcsr is not view0
    assert np.array_equal(out1, np.asarray(rg.spmm(jnp.asarray(B))))
    assert np.array_equal(out1, _t_fresh(tg.dyn.to_csr(), tg.config, B))
    assert not np.array_equal(out0, out1)
    # the GAT closures follow the same version
    q = torch.ones(n, 4)
    tg.gat(q, q, q)
    fns = dict(tg._gat_fns)
    tg.gat(q, q, q)
    assert tg._gat_fns == fns
    tg.insert_edges([1], [2], [1.0])
    tg.gat(q, q, q)
    assert tg._gat_fns[0.2] is not fns[0.2]


def test_dynamic_graph_device_and_backend(monkeypatch, rng):
    """An entry point: CUDA unless told otherwise; the engine backend is
    the CPU path."""
    _, tcsr = _int_csr(rng, 16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TGraph(tcsr, 8)
    with pytest.raises(ValueError, match="backend must be"):
        TGraph(tcsr, 8, backend="xla", device="cpu")
    g = TGraph(tcsr, 8, backend="engine", device="cpu")
    assert g.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="plain CPU path"):
        TGraph(tcsr, 8, backend="engine", device="cuda")
