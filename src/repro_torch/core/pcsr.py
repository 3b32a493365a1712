"""Parameterized Compressed Sparse Row (PCSR), packed on the host.

The paper's PCSR stores ``rowPtr/colIdx/val/TRow`` parameterized by
⟨W, F, V, S⟩ (Section 4.2).  This is the chunked layout the JAX package
packs for its Pallas kernel, kept array-for-array identical so one pack
feeds either implementation:

* nonzeros are grouped into ``V×1`` column-vectors inside V-row *panels*
  (one gathered row of ``B`` feeds V output rows);
* ``W`` panels form an output *block* of ``R = V·W`` rows — on the GPU
  the ``(R, Dblk)`` tile one thread block accumulates;
* each block's vectors are packed into fixed-capacity *chunks* of ``K``
  slots.  ``S=False`` → capacity ≈ the maximum block population;
  ``S=True`` → capacity ``K = SG`` from the mean population (the paper's
  Split Granularity, Eq. 3), so heavy blocks split across several chunks;
* ``B=True`` (requires ``S=True``) → the nnz-balanced schedule: capacity
  from ``balanced_capacity``, each block's vectors round-robined across
  its chunks, chunks emitted in LPT order (descending block population,
  each block's chunks contiguous — consumers rely only on *grouped*
  ``trow``, never ascending).

``LANES``/``SUBLANES`` stay the packing quanta of the reference layout
(``Dblk = F·LANES`` columns, capacities rounded to ``SUBLANES``) so the
packed arrays match the JAX package's exactly.

Everything here is vectorized numpy on the host — the paper performs
PCSR generation on the host as well, amortized across calls.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.obs import trace as _obs_trace

LANES = 128          # column quantum of a dim tile: Dblk = F·LANES
SUBLANES = 8         # chunk-capacity quantum

# Memory guard for the unbalanced mode: a power-law max-degree block would
# otherwise pad *every* chunk to the global max.
UNBALANCED_CAP = 8192


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


@dataclass(frozen=True)
class SpMMConfig:
    """The paper's ⟨W, F, V, S⟩ tuple, plus the ``B`` (balanced) axis.

    V: vector size of blocking (paper domain {1, 2}).
    S: workload balancing on/off.
    F: coarsening factor — dim-tile width ``Dblk = F·128`` columns.
    W: panels per output block — block height ``R = V·W`` rows.
    B: nnz-balanced chunk schedule (requires ``S=True``).
    """

    V: int = 1
    S: bool = False
    F: int = 1
    W: int = 8
    B: bool = False

    def __post_init__(self):
        if self.V < 1 or self.F < 1 or self.W < 1:
            raise ValueError(f"invalid config {self}")
        if self.B and not self.S:
            raise ValueError(f"B=True requires S=True ({self})")

    @property
    def R(self) -> int:
        return self.V * self.W

    @property
    def dblk(self) -> int:
        return self.F * LANES

    def astuple(self):
        return (self.W, self.F, self.V, self.S, self.B)

    def replace(self, **kw) -> "SpMMConfig":
        return dataclasses.replace(self, **kw)


def config_space(dim: int, max_f: int = 4):
    """The search domain for an embedding dim: V ∈ {1,2}, S ∈ {F,T},
    F ∈ [1, ceil(dim/128)], R = V·W ∈ {8,16,32}; balanced (``B=True``)
    variants come after the uniform ones so an exact price tie resolves
    to the uniform layout under ``CostModel.best``'s strict ``<``."""
    fs = list(range(1, min(max_f, _round_up(dim, LANES) // LANES) + 1))
    out = []
    for v in (1, 2):
        for s in (False, True):
            for f in fs:
                for r in (8, 16, 32):
                    out.append(SpMMConfig(V=v, S=s, F=f, W=r // v))
    for v in (1, 2):
        for f in fs:
            for r in (8, 16, 32):
                out.append(SpMMConfig(V=v, S=True, F=f, W=r // v, B=True))
    return out


@dataclass
class PCSR:
    """Packed PCSR arrays (numpy, host-resident) + bookkeeping stats."""

    config: SpMMConfig
    n_rows: int            # rows of A (= rows of C)
    n_cols: int            # cols of A (= rows of B)
    n_blocks: int          # output blocks of R rows each
    K: int                 # chunk capacity (slots)
    colidx: np.ndarray     # (C·K,) int32 — B-row per slot (pad → 0)
    lrow: np.ndarray       # (C·K,) int32 — panel idx within block
    trow: np.ndarray       # (C,)   int32 — target block per chunk
    init: np.ndarray       # (C,)   int32 — 1 iff first chunk of its block
    vals: np.ndarray       # (C,V,K) float32 — vector values (pad → 0)
    nnz: int
    nnz_vec: int           # number of nonzero vectors
    n_nonempty_blocks: int

    @property
    def num_chunks(self) -> int:
        return int(self.trow.shape[0])

    @property
    def num_slots(self) -> int:
        return self.num_chunks * self.K

    @property
    def padding_ratio(self) -> float:
        """PR_V (paper Eq. 2): 1 − nnz / (nnz_V · V)."""
        if self.nnz_vec == 0:
            return 0.0
        return 1.0 - self.nnz / (self.nnz_vec * self.config.V)

    @property
    def split_ratio(self) -> float:
        """SR (paper Eq. 4): reassigned-rowPtr length over original."""
        return self.num_chunks / max(1, self.n_nonempty_blocks)

    @property
    def slot_fill(self) -> float:
        """Fraction of chunk slots holding a real vector."""
        return self.nnz_vec / max(1, self.num_slots)

    def nbytes(self) -> int:
        """Host bytes of the packed arrays."""
        return (self.colidx.nbytes + self.lrow.nbytes + self.trow.nbytes
                + self.init.nbytes + self.vals.nbytes)

    @property
    def fini(self) -> np.ndarray:
        """(C,) int32 — 1 iff the chunk is the LAST chunk of its block:
        the chunk after which a block's output tile is complete and the
        fused epilogue runs.  ``trow`` is grouped by construction, so the
        last chunk of each block is the one whose successor targets a
        different block."""
        f = self.__dict__.get("_fini")
        if f is None:
            f = np.ones(self.num_chunks, np.int32)
            f[:-1] = (self.trow[1:] != self.trow[:-1]).astype(np.int32)
            self.__dict__["_fini"] = f
        return f

    @property
    def n_empty_blocks(self) -> int:
        """Blocks no chunk targets."""
        return self.n_blocks - len(np.unique(self.trow))

    @property
    def covered_num_chunks(self) -> int:
        """Chunk count of the *covered* steering arrays."""
        return self.num_chunks + self.n_empty_blocks

    def steering(self, covered: bool = False):
        """Steering arrays for the kernel (cached per ``covered``).

        ``covered=True`` appends one all-padding chunk per *empty* block
        (``init = fini = 1``, ``vals = 0``) so the kernel visits — and
        therefore zero-initializes and runs the epilogue on — every output
        block.  The appended chunks come LAST, so the first ``C·K``
        entries of a covered array are exactly the uncovered ones.
        """
        cache = self.__dict__.setdefault("_steering_cache", {})
        if covered in cache:
            return cache[covered]
        colidx, lrow = self.colidx, self.lrow
        trow, init, fini, vals = self.trow, self.init, self.fini, self.vals
        if covered:
            empty = np.setdiff1d(np.arange(self.n_blocks, dtype=np.int64),
                                 trow.astype(np.int64))
            E = len(empty)
            if E:
                colidx = np.concatenate([colidx, np.zeros(E * self.K, np.int32)])
                lrow = np.concatenate([lrow, np.zeros(E * self.K, np.int32)])
                trow = np.concatenate([trow, empty.astype(np.int32)])
                init = np.concatenate([init, np.ones(E, np.int32)])
                fini = np.concatenate([fini, np.ones(E, np.int32)])
                vals = np.concatenate(
                    [vals, np.zeros((E, self.config.V, self.K), np.float32)])
        cache[covered] = {"colidx": colidx, "lrow": lrow, "trow": trow,
                          "init": init, "fini": fini, "vals": vals}
        return cache[covered]


def _vectorize(indptr, indices, data, n_rows, n_cols, V):
    """Group nonzeros into V×1 panel vectors.

    Returns (vec_panel, vec_col, vec_val[nv, V]) sorted by (panel, col).
    """
    nnz = int(indices.shape[0])
    if nnz == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros((0, V), np.float32))
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
    panel = rows // V
    off = (rows - panel * V).astype(np.int64)
    key = panel * n_cols + indices.astype(np.int64)
    ukey, inv = np.unique(key, return_inverse=True)
    vec_val = np.zeros((ukey.shape[0], V), np.float32)
    # canonical CSR has unique (row, col); direct assignment is exact.
    vec_val[inv, off] = data.astype(np.float32)
    return ukey // n_cols, ukey % n_cols, vec_val


def split_granularity(nnz_vec: int, n_nonempty_blocks: int) -> int:
    """Paper Eq. 3: SG = CEILDIV(d̂_V, ω)·ω, rounded to ``SUBLANES``."""
    mean = -(-max(1, nnz_vec) // max(1, n_nonempty_blocks))
    return max(SUBLANES, _round_up(mean, SUBLANES))


# Chunks a balanced schedule is willing to add per removed slot-octet: the
# capacity search charges each extra chunk as ``BALANCE_LAMBDA`` padding
# slots.
BALANCE_LAMBDA = 4.0


def balanced_capacity(counts, lam: float = BALANCE_LAMBDA,
                      unbalanced_cap: int = UNBALANCED_CAP) -> int:
    """Chunk capacity minimizing ``slots(K) + lam · chunks(K)`` over the
    block-population distribution.  Candidates are the ``SUBLANES``
    roundups of the population quantiles + mean."""
    counts = np.asarray(counts, np.int64)
    counts = counts[counts > 0]
    if counts.size == 0:
        return SUBLANES
    qs = np.quantile(counts, [0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0])
    cand = {max(SUBLANES, min(_round_up(int(q), SUBLANES),
                              _round_up(unbalanced_cap, SUBLANES)))
            for q in np.concatenate([qs, [counts.mean()]])}
    best_k, best_obj = SUBLANES, np.inf
    for K in sorted(cand):
        nch = -(-counts // K)
        C = int(nch.sum())
        obj = C * K + lam * C
        if obj < best_obj:
            best_k, best_obj = K, obj
    return best_k


def build_pcsr(indptr, indices, data, n_rows, n_cols,
               config: SpMMConfig, unbalanced_cap: int = UNBALANCED_CAP,
               capacity: int | None = None) -> PCSR:
    """PCSR generation (paper §4.2), fully vectorized.

    ``config.B`` selects the nnz-balanced packer (capacity from
    ``balanced_capacity``, round-robin slots, LPT chunk order).
    ``capacity`` pins the chunk capacity ``K`` (rounded to ``SUBLANES``)
    instead of deriving it from the matrix — the serving tier uses this
    so every graph packed into one shape bucket shares the bucket's fixed
    chunk geometry.
    """
    if not _obs_trace.trace_enabled():
        return _build_pcsr(indptr, indices, data, n_rows, n_cols,
                           config, unbalanced_cap, capacity)
    with _obs_trace.span("pcsr.build", config=str(config.astuple()),
                         n_rows=int(n_rows),
                         nnz=int(np.asarray(indices).shape[0])):
        return _build_pcsr(indptr, indices, data, n_rows, n_cols,
                           config, unbalanced_cap, capacity)


def _build_pcsr(indptr, indices, data, n_rows, n_cols,
                config: SpMMConfig, unbalanced_cap: int,
                capacity: int | None = None) -> PCSR:
    V, W, S, Bal = config.V, config.W, config.S, config.B
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    data = np.asarray(data)
    nnz = int(indices.shape[0])
    n_panels = max(1, _round_up(n_rows, V) // V)
    n_blocks = max(1, _round_up(n_panels, W) // W)

    vec_panel, vec_col, vec_val = _vectorize(indptr, indices, data,
                                             n_rows, n_cols, V)
    nv = int(vec_panel.shape[0])
    bid = vec_panel // W                      # block of each vector (sorted)
    lrow_vec = (vec_panel - bid * W).astype(np.int32)
    counts = np.bincount(bid.astype(np.int64), minlength=n_blocks) if nv \
        else np.zeros(n_blocks, np.int64)
    nonempty = int((counts > 0).sum())

    if capacity is not None:
        K = max(SUBLANES, _round_up(capacity, SUBLANES))
    elif Bal:
        K = balanced_capacity(counts, unbalanced_cap=unbalanced_cap)
    elif S:
        K = split_granularity(nv, nonempty)
    else:
        K = min(_round_up(max(1, counts.max() if nv else 1), SUBLANES),
                _round_up(unbalanced_cap, SUBLANES))

    nch = -(-counts // K)                     # chunks per block (0 if empty)
    C = int(nch.sum())
    if C == 0:                                # degenerate: all-zero matrix
        return PCSR(config, n_rows, n_cols, n_blocks, K,
                    np.zeros(K, np.int32), np.zeros(K, np.int32),
                    np.zeros(1, np.int32), np.ones(1, np.int32),
                    np.zeros((1, V, K), np.float32), nnz, nv, nonempty)

    # emitted block order: ascending for the uniform modes, LPT
    # (descending population, stable) for the balanced schedule
    border = (np.argsort(-counts, kind="stable") if Bal
              else np.arange(n_blocks, dtype=np.int64))
    nch_ord = nch[border]
    starts_ord = np.concatenate([[0], np.cumsum(nch_ord)])
    first_chunk = np.empty(n_blocks, np.int64)
    first_chunk[border] = starts_ord[:-1]     # block id → its first chunk
    trow = np.repeat(border, nch_ord).astype(np.int32)
    init = np.zeros(C, np.int32)
    init[starts_ord[:-1][nch_ord > 0]] = 1

    # slot of each vector: rank within its block → (chunk, slot)
    block_vec_start = np.concatenate([[0], np.cumsum(counts)])
    rank = np.arange(nv, dtype=np.int64) - block_vec_start[bid]
    if Bal:
        # round-robin: each chunk of the block gets an even share
        chunk_g = first_chunk[bid] + rank % nch[bid]
        slot = rank // nch[bid]
    else:
        chunk_g = first_chunk[bid] + rank // K
        slot = rank % K

    colidx = np.zeros(C * K, np.int32)
    lrow = np.zeros(C * K, np.int32)
    vals = np.zeros((C, V, K), np.float32)
    pos = chunk_g * K + slot
    colidx[pos] = vec_col.astype(np.int32)
    lrow[pos] = lrow_vec
    vals[chunk_g[:, None], np.arange(V)[None, :], slot[:, None]] = vec_val
    return PCSR(config, n_rows, n_cols, n_blocks, K, colidx, lrow,
                trow, init, vals, nnz, nv, nonempty)


def pad_pcsr(p: PCSR, *, n_rows: int, n_cols: int | None = None,
             num_chunks: int | None = None) -> PCSR:
    """Pad a PCSR to a fixed bucket shape (serving tier).

    Returns a PCSR whose geometry is exactly ``(n_rows, n_cols,
    num_chunks)`` regardless of the input graph.  Appended after the real
    chunks: one all-padding *coverage* chunk per empty block (``init=1``,
    ascending block id), then ``num_chunks - C - E`` *filler* chunks
    (``init=0``, all padding) targeting the last empty block.  The result
    has zero empty blocks and grouped ``trow``, so the epilogue fires
    exactly once per block.  Callers must leave at least one empty block
    whenever filler is needed (the serve bucket geometry adds one).
    """
    cfg = p.config
    n_cols = n_rows if n_cols is None else n_cols
    if n_rows < p.n_rows or n_cols < p.n_cols:
        raise ValueError(
            f"pad_pcsr target ({n_rows}x{n_cols}) smaller than "
            f"packed matrix ({p.n_rows}x{p.n_cols})")
    n_panels = max(1, _round_up(n_rows, cfg.V) // cfg.V)
    n_blocks = max(1, _round_up(n_panels, cfg.W) // cfg.W)
    covered = np.unique(p.trow.astype(np.int64))
    empty = np.setdiff1d(np.arange(n_blocks, dtype=np.int64), covered)
    E = int(empty.size)
    C = p.num_chunks
    target = C + E if num_chunks is None else int(num_chunks)
    filler = target - C - E
    if filler < 0:
        raise ValueError(
            f"pad_pcsr chunk budget {target} < required {C + E} "
            f"(C={C} real + E={E} coverage)")
    if filler > 0 and E == 0:
        raise ValueError(
            "pad_pcsr needs an empty block to host filler chunks — "
            "size the bucket with at least one spare row block")
    pad = E + filler
    if pad == 0:
        return PCSR(cfg, n_rows, n_cols, n_blocks, p.K, p.colidx, p.lrow,
                    p.trow, p.init, p.vals, p.nnz, p.nnz_vec,
                    p.n_nonempty_blocks)
    trow_pad = np.concatenate(
        [empty, np.full(filler, empty[-1] if E else 0, np.int64)])
    trow = np.concatenate([p.trow, trow_pad.astype(np.int32)])
    init = np.concatenate(
        [p.init, np.ones(E, np.int32), np.zeros(filler, np.int32)])
    colidx = np.concatenate([p.colidx, np.zeros(pad * p.K, np.int32)])
    lrow = np.concatenate([p.lrow, np.zeros(pad * p.K, np.int32)])
    vals = np.concatenate(
        [p.vals, np.zeros((pad, cfg.V, p.K), np.float32)])
    return PCSR(cfg, n_rows, n_cols, n_blocks, p.K, colidx, lrow,
                trow, init, vals, p.nnz, p.nnz_vec, p.n_nonempty_blocks)


@dataclass
class PCSRStats:
    """Exact per-(V, W) block-population stats — enough to cost every
    (S, B, F) choice without materializing the packed arrays."""

    n_rows: int
    n_cols: int
    nnz: int
    V: int
    W: int
    nnz_vec: int
    n_blocks: int
    n_nonempty_blocks: int
    max_block: int
    mean_block: float
    counts_hist: np.ndarray   # per-nonempty-block vector counts

    def chunks_and_slots(self, S: bool, unbalanced_cap: int = UNBALANCED_CAP,
                         B: bool = False):
        """(C, K, slots) of the layout ⟨S, B⟩ would pack — the same
        capacity rules ``build_pcsr`` applies."""
        if self.n_nonempty_blocks == 0:
            return 1, SUBLANES, SUBLANES
        if B:
            K = balanced_capacity(self.counts_hist,
                                  unbalanced_cap=unbalanced_cap)
        elif S:
            K = split_granularity(self.nnz_vec, self.n_nonempty_blocks)
        else:
            K = min(_round_up(max(1, self.max_block), SUBLANES),
                    _round_up(unbalanced_cap, SUBLANES))
        nch = -(-self.counts_hist // K)
        C = int(nch.sum())
        return C, K, C * K

    @property
    def padding_ratio(self) -> float:
        if self.nnz_vec == 0:
            return 0.0
        return 1.0 - self.nnz / (self.nnz_vec * self.V)


def pcsr_stats(indptr, indices, n_rows, n_cols, V: int, W: int) -> PCSRStats:
    """Vectorization + block statistics only (the cost model's input)."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    nnz = int(indices.shape[0])
    n_panels = max(1, _round_up(n_rows, V) // V)
    n_blocks = max(1, _round_up(n_panels, W) // W)
    if nnz == 0:
        return PCSRStats(n_rows, n_cols, 0, V, W, 0, n_blocks, 0, 0, 0.0,
                         np.zeros(0, np.int64))
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
    key = np.sort((rows // V) * n_cols + indices)
    # np.unique(key) by sorting: numpy ≥ 2.3 takes a hash-table path for
    # a bare np.unique that is ~20× slower on multi-million-key arrays
    ukey = key[np.concatenate(([True], key[1:] != key[:-1]))]
    bid = (ukey // n_cols) // W
    counts = np.bincount(bid, minlength=n_blocks)
    ne = counts[counts > 0]
    return PCSRStats(n_rows, n_cols, nnz, V, W, int(ukey.shape[0]), n_blocks,
                     int(ne.shape[0]), int(ne.max()), float(ne.mean()),
                     ne.astype(np.int64))


def transpose_csr(indptr, indices, data, n_rows, n_cols):
    """CSR of Aᵀ (for the backward SpMM dB = Aᵀ·dC)."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    data = np.asarray(data)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
    order = np.argsort(indices, kind="stable")
    t_counts = np.bincount(indices, minlength=n_cols)
    t_indptr = np.concatenate([[0], np.cumsum(t_counts)]).astype(np.int64)
    return t_indptr, rows[order], data[order], n_cols, n_rows


def pcsr_slot_coords(p: PCSR):
    """Dense coordinates of every *real* slot entry (stored value ≠ 0):
    ``(rows, cols, flat)`` — the (row, col) of each edge and its flat
    index into ``vals.reshape(-1)``, the (C, V, K) slot order."""
    c, v, k = np.nonzero(p.vals)
    ck = c * p.K + k
    rows = (p.trow[c].astype(np.int64) * p.config.R
            + p.lrow[ck].astype(np.int64) * p.config.V + v)
    cols = p.colidx[ck].astype(np.int64)
    flat = (c * p.config.V + v) * p.K + k
    return rows, cols, flat


def pcsr_to_coo(p: PCSR):
    """The (rows, cols, vals) edge list packed into a PCSR."""
    rows, cols, flat = pcsr_slot_coords(p)
    return rows, cols, p.vals.reshape(-1)[flat]


def transpose_pcsr(p: PCSR, config: SpMMConfig | None = None) -> PCSR:
    """PCSR of Aᵀ under the forward PCSR's configuration (or ``config``),
    built from its own edge list; every backward SpMM runs on it."""
    rows, cols, vals = pcsr_to_coo(p)
    order = np.lexsort((rows, cols))           # CSR of Aᵀ: sort by (col, row)
    t_indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(cols, minlength=p.n_cols))]).astype(
            np.int64)
    return build_pcsr(t_indptr, rows[order], vals[order],
                      p.n_cols, p.n_rows, config or p.config)


def slot_transfer_map(p: PCSR, p_t: PCSR):
    """Flat-index pair moving per-edge slot values A-layout → Aᵀ-layout:
    for each edge (i, j) of A, ``f_idx`` is its flat position in ``p``'s
    (C, V, K) slot tensor and ``t_idx`` its flat position in ``p_t``'s.
    Both index the uncovered layouts, which are the first entries of the
    covered ones; padding slots are in neither."""
    rows, cols, f_flat = pcsr_slot_coords(p)
    t_rows, t_cols, t_flat = pcsr_slot_coords(p_t)
    key_f = rows * p.n_cols + cols
    key_t = t_cols * p.n_cols + t_rows        # Aᵀ edge (j, i) ↔ A edge (i, j)
    of, ot = np.argsort(key_f), np.argsort(key_t)
    if not np.array_equal(key_f[of], key_t[ot]):
        raise ValueError("PCSR pair does not pack the same edge set")
    return f_flat[of].astype(np.int32), t_flat[ot].astype(np.int32)
