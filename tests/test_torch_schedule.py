"""The kernels' work schedule (``kernels/paramspmm/ops.py::work_units``).

The ParamSpMM and SDDMM→softmax kernels run one thread block per *work
unit*: a contiguous slot range of at most ``cap`` real slots inside one
chunk group.  The units of a split group write partials that a merge step
combines in unit order.  Here, on the CPU:

* the unit table's invariants, over the 18 configs of
  ``config_space(64)`` × {power-law graph with a hub, uniform graph, graph
  with empty blocks} × {plain pack, bucket-padded pack} × {the wrapper's
  cap, a tiny one}: every slot lies in exactly one unit; units stay inside
  their group, in slot order; no unit holds more than ``cap`` real slots,
  and a unit is cut inside a chunk only where that chunk alone holds more;
  groups at or under the cap are one unit; the table is the same from run
  to run;
* an emulation of the kernels' arithmetic by units — per unit the plain
  engine on its slots, split groups' partials summed in unit order, then
  ``apply_epilogue``; (max, Σexp) per unit merged in unit order with the
  flash rescale — equals the plain versions (which the other test files
  hold against the JAX reference): bit-exact on integer operands, stats
  within 1e-6 relative, rows whose every partial is empty included;
* the raw SDDMM kernel's arithmetic by units — each unit's R rows of Q
  as one tile, each slot's Q row read from it by local row, the dot over
  column tiles in order, units cut into pieces, every slot written
  once — equals ``sddmm_plain``
  (bit-exact on integer operands, ``rtol=atol=1e-5`` on float ones) and
  the reference's Pallas ``sddmm`` in interpret mode (the only cases here
  that import the JAX package);
* ``ops.SteeringArgs`` against ``csrc/steering.h``, the struct the three
  C entry points take, and its cache beside each ``Steering``.
"""
import ctypes
import dataclasses
import functools
import gc
import re

import numpy as np
import pytest
import torch

from repro_torch.core.engine import _slot_rows, apply_epilogue
from repro_torch.core.pcsr import (SpMMConfig, build_pcsr, config_space,
                                   pad_pcsr)
from repro_torch.core.sparse import CSRMatrix
from repro_torch.kernels.paramspmm import ops
from repro_torch.kernels.sddmm import ops as sddmm_ops

TINY_CAP = 5
N = 300


def _graph(kind: str, integer: bool = True, seed: int = 0) -> CSRMatrix:
    """``hub``: sparse random edges plus one row and one column touching
    every node (a hub group far above the mean); ``uniform``: every row
    has 4 edges; ``empty``: random edges with rows 64..191 empty."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        rows = np.repeat(np.arange(N), 4)
        cols = (rows * 7 + np.tile(np.arange(4), N) * 31 + 1) % N
    else:
        m = 3 * N
        rows, cols = rng.integers(0, N, m), rng.integers(0, N, m)
        if kind == "hub":
            hub = np.arange(N)
            rows = np.concatenate([rows, np.full(N, 3), hub])
            cols = np.concatenate([cols, hub, np.full(N, 5)])
        else:
            keep = (rows < 64) | (rows >= 192)
            rows, cols = rows[keep], cols[keep]
    key = np.unique(rows * N + cols)
    rows, cols = key // N, key % N
    vals = (rng.integers(1, 4, rows.size) * rng.choice([-1, 1], rows.size)
            if integer else rng.standard_normal(rows.size))
    return CSRMatrix.from_coo(rows, cols, vals.astype(np.float32), N, N,
                              sum_duplicates=False)


def _pack(csr, cfg, padded: bool):
    p = build_pcsr(csr.indptr, csr.indices, csr.data, csr.n_rows,
                   csr.n_cols, cfg)
    if padded:
        # the serving tier's shape: two spare row blocks, filler chunks
        p = pad_pcsr(p, n_rows=csr.n_rows + 2 * cfg.R,
                     num_chunks=p.covered_num_chunks + 2 + 3)
    return p


def _real(st):
    return (st["vals"] != 0).any(axis=1).reshape(-1)


GRAPHS = ("hub", "uniform", "empty")


@pytest.mark.parametrize("cap", [None, TINY_CAP], ids=["cap", "tiny"])
@pytest.mark.parametrize("padded", [False, True], ids=["plain", "bucket"])
@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("cfg", config_space(64),
                         ids=lambda c: str(c.astuple()))
def test_unit_table_invariants(cfg, kind, padded, cap):
    p = _pack(_graph(kind), cfg, padded)
    st = p.steering(covered=True)
    K = p.K
    groups = ops.group_table(st["trow"], st["init"], st["fini"], p.n_blocks)
    units, splits, n_partials, used, most, span = ops.work_units(
        st["vals"], groups, K, cap)
    real = _real(st)
    cum = np.concatenate([[0], np.cumsum(real)])
    b, e, g, part = units.T.astype(np.int64)
    # every slot in exactly one unit, units in slot order
    assert units.dtype == np.int32 and b[0] == 0
    assert e[-1] == len(st["trow"]) * K
    assert np.array_equal(b[1:], e[:-1]) and np.all(e > b)
    # inside their group, groups in order
    assert np.all(np.diff(g) >= 0) and set(g) == set(range(p.n_blocks))
    assert np.all(groups[g] * K <= b) and np.all(e <= groups[g + 1] * K)
    # at most cap real slots; a cut inside a chunk only where the chunk
    # alone holds more than cap
    per_unit = cum[e] - cum[b]
    assert np.all(per_unit <= used) and most == per_unit.max()
    assert span == (e - b).max()
    inner = b[(b % K != 0)]
    chunk_real = real.reshape(-1, K).sum(axis=1)
    assert np.all(chunk_real[inner // K] > used)
    # groups at or under the cap are one unit, written directly; split
    # groups' units hold consecutive partials
    per_group = np.bincount(g, weights=per_unit, minlength=p.n_blocks)
    n_units = np.bincount(g, minlength=p.n_blocks)
    assert np.all(n_units[per_group <= used] == 1)
    assert np.all(part[np.isin(g, np.flatnonzero(n_units == 1))] == -1)
    assert np.array_equal(splits[:, 0], np.flatnonzero(n_units > 1))
    for sg, p0, p1 in splits:
        assert np.array_equal(part[g == sg], np.arange(p0, p1))
    assert n_partials == int((part >= 0).sum())
    # the same table from run to run
    again = ops.work_units(st["vals"], groups, K, cap)
    assert np.array_equal(again[0], units) and np.array_equal(again[1],
                                                              splits)
    if cap is None:
        assert used == ops.unit_cap(per_group)
        if kind == "hub":       # the hub's group spans several units
            assert n_units.max() >= 2
        if kind == "uniform":   # no group exceeds twice the mean
            assert n_partials == 0


def test_unit_cap_from_the_pack():
    assert ops.unit_cap(np.array([0, 10, 10, 10])) == ops.UNIT_MIN_CAP
    assert ops.unit_cap(np.array([0, 300, 500, 22000])) == 2 * 7600
    assert ops.unit_cap(np.zeros(3, np.int64)) == ops.UNIT_MIN_CAP
    with pytest.raises(ValueError, match="cap"):
        ops.work_units(np.zeros((1, 1, 8), np.float32),
                       np.array([0, 1], np.int32), 8, 0)


def test_steering_carries_the_unit_table():
    cfg = SpMMConfig(V=2, S=True, W=4)
    p = _pack(_graph("hub"), cfg, False)
    st = ops.Steering.from_pcsr(p, "cpu", cap=TINY_CAP)
    assert st.cap == TINY_CAP and st.n_units > st.n_groups
    assert st.n_partials == int((st.units[:, 3] >= 0).sum())
    assert tuple(st.splits.shape) == (int((st.splits[:, 0] >= 0).sum()), 3)
    # each split row names its group's output block, as the merges write it
    host = p.steering(covered=True)
    groups = st.groups.numpy()
    _, splits, *_ = ops.work_units(host["vals"], groups, p.K, TINY_CAP)
    assert np.array_equal(st.splits[:, 0].numpy(),
                          host["trow"][groups[splits[:, 0]]])
    assert np.array_equal(st.splits[:, 1:].numpy(), splits[:, 1:])
    assert ops.device_steering(p, "cpu").cap >= ops.UNIT_MIN_CAP
    # a unit table that does not tile the steering is refused
    bad = ops.Steering(**{**st.__dict__, "units": st.units[:-1]})
    with pytest.raises(ValueError, match="unit table"):
        ops.check_steering(bad, V=2, R=cfg.R, K=p.K, n_blocks=p.n_blocks,
                           n_rows=p.n_rows)


def test_steering_args_follow_the_header():
    """``ops.SteeringArgs`` lists ``csrc/steering.h``'s fields in its
    order, pointers as pointers and sizes as ints."""
    from repro_torch.kernels import build
    text = (build.CSRC_DIR / "steering.h").read_text()
    body = re.search(r"struct SteeringArgs \{(.*?)\};", text, re.S).group(1)
    want = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if decl:
            kind = "ptr" if "*" in decl else "int"
            names = decl.split("*")[-1] if kind == "ptr" else decl[4:]
            want += [(n.strip(), kind) for n in names.split(",")]
    got = [(name, "ptr" if t is ctypes.c_void_p else "int")
           for name, t in ops.SteeringArgs._fields_]
    assert got == want
    assert all(t in (ctypes.c_void_p, ctypes.c_int)
               for _, t in ops.SteeringArgs._fields_)


def test_steering_args_are_cached_off_the_instance():
    """The struct is built once per ``Steering`` and kept beside it, not
    in its fields: a copy built from them packs its own."""
    p = _pack(_graph("hub"), SpMMConfig(V=2, S=True, W=4), False)
    st = ops.Steering.from_pcsr(p, "cpu", cap=TINY_CAP)
    args = ops.steering_args(st, "paramspmm")
    assert ops.steering_args(st, "paramspmm") is args
    assert set(st.__dict__) == {f.name for f in dataclasses.fields(st)}
    copy = ops.Steering(**{**st.__dict__, "units": st.units.clone()})
    assert ops.steering_args(copy, "paramspmm").units != args.units
    assert args.n_units == st.n_units and args.n_splits == len(st.splits)
    n = len(ops._STEERING_ARGS)
    del copy
    gc.collect()
    assert len(ops._STEERING_ARGS) == n - 1


# ------------------------------------------------------------ emulation
def _by_unit(steer, *, R, V, K):
    """Per slot of the covered layout ``(C, V, K)``: its unit's index and
    its row inside the unit's (R,) tile.  A padded table's empty units
    begin past the last slot, so no slot falls in one."""
    C = steer.trow.shape[0]
    slot = torch.arange(C * K).reshape(C, 1, K)
    unit = torch.searchsorted(steer.units[:, 0].long().contiguous(), slot,
                              right=True) - 1
    local = (_slot_rows(steer.lrow, steer.trow, V=V, R=R, K=K)
             - steer.trow.long()[:, None, None] * R)
    return unit.expand(C, V, K), local


def _in_unit_order(steer, parts, write):
    """Combine each split group's partials in unit order: ``parts`` is
    indexed by partial, ``write(block, rows of the group's partials in
    order)`` stores the result.  Empty (padding) splits are skipped, as
    the merge kernels skip them."""
    for block, p0, p1 in steer.splits.tolist():
        if p1 > p0:
            write(block, parts[p0:p1])


def _unit_blocks(steer, K):
    """The output block of each non-empty unit, and the mask of those
    units (a padded table's empty units have no block)."""
    live = steer.units[:, 0] < steer.units[:, 1]
    return steer.trow.long()[steer.units[live, 0].long() // K], live


def emulate_spmm(steer, B, *, V, R, K, n_blocks, n_rows, vals=None,
                 scale=None, bias=None, residual=None, activation="none"):
    """The kernel's arithmetic by units: the plain engine on each unit's
    slots into the unit's own (R, dim) tile, a split group's partial tiles
    summed in unit order, then the epilogue once."""
    vals = steer.vals if vals is None else vals
    unit, local = _by_unit(steer, R=R, V=V, K=K)
    gathered = B.index_select(0, steer.colidx.long()).reshape(
        -1, 1, K, B.shape[1])
    tiles = B.new_zeros((steer.n_units * R, B.shape[1]))
    tiles.index_add_(0, (unit * R + local).reshape(-1),
                     (vals[..., None] * gathered).reshape(-1, B.shape[1]))
    tiles = tiles.reshape(steer.n_units, R, -1)
    out = B.new_zeros((n_blocks, R, B.shape[1]))
    blocks, live = _unit_blocks(steer, K)
    direct = steer.units[live, 3] < 0
    out[blocks[direct]] = tiles[live][direct]
    parts = tiles[steer.units[:, 3] >= 0]    # partials in partial order

    def write(block, ps):
        y = ps[0]
        for q in ps[1:]:
            y = y + q
        out[block] = y
    _in_unit_order(steer, parts, write)
    return apply_epilogue(out.reshape(n_blocks * R, -1)[:n_rows], scale,
                          bias, activation, ops.LEAKY_SLOPE, residual)


def emulate_stats(steer, logits, *, V, R, K, n_blocks):
    """(max, Σexp) per unit and row, then a split group's pairs merged in
    unit order with the flash rescale and the guards (a non-finite max
    leaves the sum as it is); a group that is one unit keeps its pair."""
    unit, local = _by_unit(steer, R=R, V=V, K=K)
    idx = (unit * R + local).reshape(-1)
    x = logits.double().reshape(-1)
    m = torch.full((steer.n_units * R,), -torch.inf, dtype=torch.float64)
    m = m.scatter_reduce(0, idx, x, "amax")
    mg = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.zeros_like(m).index_add_(0, idx, torch.exp(x - mg[idx]))
    m, s = m.reshape(-1, R), s.reshape(-1, R)
    rowmax = torch.full((n_blocks, R), -torch.inf, dtype=torch.float64)
    rowsum = torch.zeros((n_blocks, R), dtype=torch.float64)
    blocks, live = _unit_blocks(steer, K)
    direct = steer.units[live, 3] < 0
    rowmax[blocks[direct]] = m[live][direct]
    rowsum[blocks[direct]] = s[live][direct]
    split = steer.units[:, 3] >= 0
    parts = torch.stack([m[split], s[split]], dim=1)

    def write(block, ps):
        mx = ps[:, 0].max(dim=0).values
        ok = torch.isfinite(mx)
        total = torch.zeros(R, dtype=torch.float64)
        for pm, ps_ in ps:                                  # unit order
            total = total + ps_ * torch.exp(pm - torch.where(ok, mx, 0.0))
        rowmax[block], rowsum[block] = mx, torch.where(ok, total, 0.0)
    _in_unit_order(steer, parts, write)
    return rowmax.reshape(-1).float(), rowsum.reshape(-1).float()


EMU_CONFIGS = [SpMMConfig(V=v, S=s, B=b, F=1, W=r // v)
               for v in (1, 2) for s, b in ((False, False), (True, False),
                                            (True, True))
               for r in (8, 32)]


@pytest.mark.parametrize("cap", [None, TINY_CAP], ids=["cap", "tiny"])
@pytest.mark.parametrize("kind", ("hub", "empty"))
@pytest.mark.parametrize("cfg", EMU_CONFIGS, ids=lambda c: str(c.astuple()))
def test_emulated_units_match_plain(cfg, kind, cap):
    V, R = cfg.V, cfg.R
    rng = np.random.default_rng(3)
    for integer in (True, False):
        p = _pack(_graph(kind, integer=integer), cfg, padded=False)
        steer = ops.Steering.from_pcsr(p, "cpu", cap=cap)
        geo = dict(V=V, R=R, K=p.K, n_blocks=p.n_blocks, n_rows=p.n_rows)
        draw = ((lambda *s: torch.from_numpy(
                    rng.integers(-3, 4, s).astype(np.float32)))
                if integer else
                (lambda *s: torch.from_numpy(
                    rng.standard_normal(s).astype(np.float32))))
        B = draw(N, 24)
        epi = dict(scale=draw(N), bias=draw(24), residual=draw(N, 24),
                   activation="leaky_relu")
        for kw in ({}, epi):
            got = emulate_spmm(steer, B, **geo, **kw)
            want = ops.paramspmm_plain(steer, B, **geo, **kw)
            if integer:
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        Q, Km = draw(1, N, 16), draw(1, N, 16)
        logits, rowmax, rowsum = sddmm_ops.sddmm_softmax_plain(
            steer, Q, Km, scale=0.25, slope=0.2, **geo)
        m, s = emulate_stats(steer, logits[0], V=V, R=R, K=p.K,
                             n_blocks=p.n_blocks)
        assert torch.equal(m, rowmax[0])
        torch.testing.assert_close(s, rowsum[0], rtol=1e-6, atol=0)
        # the prologue by units: α from the stats, then the SpMM
        alpha = sddmm_ops.normalize_from_stats(
            logits[0], rowmax[0], rowsum[0], steer.lrow, steer.trow, R=R,
            V=V, K=p.K)
        got = emulate_spmm(steer, B, vals=alpha, **geo)
        want = ops.paramspmm_plain(steer, B[None], vals=logits,
                                   rowmax=rowmax, rowsum=rowsum, **geo)[0]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        if kind == "empty" and cap == TINY_CAP:
            # some split group has rows whose every partial is empty
            split_blocks = steer.splits[:, 0].tolist()
            rows = torch.tensor([b * R + r for b in split_blocks
                                 for r in range(R)])
            assert bool(torch.isneginf(m[rows]).any())
            assert bool((s[rows][torch.isneginf(m[rows])] == 0).all())


def emulate_sddmm(steer, Q, K_mat, *, V, R, K, n_rows, tile_cols=None,
                  parts=1):
    """The raw SDDMM kernel's arithmetic by units, for ``Q`` ``(H, n_rows,
    d)``: each unit's R rows of Q as one tile (its block's rows from
    ``trow`` of the unit's first slot; rows ≥ ``n_rows`` NaN, so a slot
    that read one would show), each slot's Q row read from its unit's tile
    by local row, its dot with the gathered ``K_mat`` row summed over
    column tiles of ``tile_cols`` (default all of d) in order.  Each unit
    is cut into ``parts`` pieces as the kernel cuts it on a small grid;
    a slot no piece covers stays NaN, one that two cover fails.  Written
    slots are 0 where they hold no stored nonzero or their row is past
    ``n_rows``.  Returns ``(H, C, V, K)``."""
    H, _, d = Q.shape
    C = steer.trow.shape[0]
    unit, local = _by_unit(steer, R=R, V=V, K=K)              # (C, V, K)
    row0 = steer.trow.long()[steer.units[:, 0].long() // K] * R
    rows = row0[:, None] + torch.arange(R)                    # (U, R)
    tiles = Q[:, rows.clamp(max=n_rows - 1)]                  # (H, U, R, d)
    tiles = torch.where((rows < n_rows)[None, :, :, None], tiles,
                        torch.nan)
    q = tiles[:, unit, local]                                 # (H, C, V, K, d)
    k = K_mat[:, steer.colidx.long()].reshape(H, C, 1, K, d)
    step = tile_cols or d
    dots = (q[..., :step] * k[..., :step]).sum(-1)
    for c0 in range(step, d, step):
        dots = dots + (q[..., c0:c0 + step] * k[..., c0:c0 + step]).sum(-1)
    real = (steer.vals != 0) & (row0[unit] + local < n_rows)
    written = torch.zeros(C * K, dtype=torch.bool)
    for b, e, _, _ in steer.units.tolist():
        for part in range(parts):          # csrc/sddmm.cu's [s0, s1)
            s0 = b + (e - b) * part // parts
            s1 = b + (e - b) * (part + 1) // parts
            assert not written[s0:s1].any(), "a slot in two pieces"
            written[s0:s1] = True
    return torch.where(written.reshape(C, 1, K),
                       torch.where(real, dots, 0.0), torch.nan)


def _raw_operands(H, integer, d=16):
    rng = np.random.default_rng(9 + H + 10 * integer)
    draw = ((lambda *s: rng.integers(-3, 4, s)) if integer
            else (lambda *s: rng.standard_normal(s)))
    return tuple(torch.from_numpy(draw(H, N, d).astype(np.float32))
                 for _ in range(2))


@functools.lru_cache(maxsize=None)
def _reference_sddmm(cfg, kind, H, integer):
    """The reference's Pallas ``sddmm`` (interpret mode) on the same CSR
    and operands: ``(H, num_chunks, V, K)`` in the uncovered layout.  It
    does not depend on the unit cap, so both caps share one call."""
    import jax.numpy as jnp
    from repro.core import pcsr as rp
    from repro.kernels.sddmm import ops as rsops
    csr = _graph(kind, integer=integer)
    r = rp.build_pcsr(csr.indptr, csr.indices, csr.data, csr.n_rows,
                      csr.n_cols, rp.SpMMConfig(V=cfg.V, S=cfg.S, F=cfg.F,
                                                W=cfg.W, B=cfg.B))
    Q, Km = _raw_operands(H, integer)
    return torch.from_numpy(np.array(rsops.sddmm(
        r, jnp.asarray(Q.numpy()), jnp.asarray(Km.numpy()),
        interpret=True)))


@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("cap", [None, TINY_CAP], ids=["cap", "tiny"])
@pytest.mark.parametrize("kind", ("hub", "empty"))
@pytest.mark.parametrize("cfg", EMU_CONFIGS, ids=lambda c: str(c.astuple()))
def test_emulated_raw_sddmm_matches_plain_and_reference(cfg, kind, cap, H):
    for integer in (True, False):
        p = _pack(_graph(kind, integer=integer), cfg, padded=False)
        steer = ops.Steering.from_pcsr(p, "cpu", cap=cap)
        geo = dict(V=cfg.V, R=cfg.R, K=p.K, n_rows=p.n_rows)
        Q, Km = _raw_operands(H, integer)
        plain = sddmm_ops.sddmm_plain(steer, Q, Km, **geo)
        ref = _reference_sddmm(cfg, kind, H, integer)
        C = p.num_chunks
        assert ref.shape == (H, C, cfg.V, p.K)
        # d whole in one piece a unit; d in 4-column tiles, units in 3
        for tile_cols, parts in ((None, 1), (4, 3)):
            got = emulate_sddmm(steer, Q, Km, tile_cols=tile_cols,
                                parts=parts, **geo)
            assert bool((got[:, steer.vals == 0] == 0).all())
            assert bool((got[:, C:] == 0).all()), "coverage chunks are 0"
            if integer:
                assert torch.equal(got, plain)
                assert torch.equal(got[:, :C], ref)
            else:
                torch.testing.assert_close(got, plain, rtol=1e-5,
                                           atol=1e-5)
                torch.testing.assert_close(got[:, :C], ref, rtol=1e-5,
                                           atol=1e-5)
