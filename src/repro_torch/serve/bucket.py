"""Shape buckets — the serving tier's fixed-geometry contract.

Every inference request carries a different sampled subgraph.  Serving
rounds each request batch up to one of a small, fixed ladder of
``(node_ceiling, edge_ceiling)`` buckets; a bucket maps to one
``PackGeom`` — a fully static PCSR geometry (rows, blocks, chunk count,
chunk capacity, ⟨W,F,V,S,B⟩ config) — so every batch packed into the
bucket produces steering arrays of identical shapes and the kernel is
launched over the same grid (one chunk group per output block).

The bucket geometry leaves deliberate headroom:

* ``n_rows = round_up(n_ceil, R) + R`` — one extra, always-empty row
  block, so ``pad_pcsr`` always has a legal target for its filler
  chunks even when a batch lands exactly on the node ceiling;
* ``num_chunks = n_blocks + ceil(e_ceil / K)`` — enough for any edge
  distribution at or under the ceiling.

The kernels' work schedule is fixed per geometry too: ``PackGeom.bounds``
(``kernels.paramspmm.ops.schedule_bounds``) caps the units, split groups
and partials of any batch's table, and every batch's table is padded to
those bounds, so one captured grid serves the bucket.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.pcsr import (PCSR, SUBLANES, SpMMConfig, _round_up,
                                   build_pcsr, pad_pcsr)
from repro_torch.core.sparse import CSRMatrix
from repro_torch.kernels.paramspmm.ops import (ScheduleBounds, Steering,
                                               schedule_bounds)


@dataclass(frozen=True)
class ShapeBucket:
    """One rung of the padding ladder: requests with ``n ≤ n_ceil`` nodes
    and ``e ≤ e_ceil`` edges are padded up to exactly this shape."""

    n_ceil: int
    e_ceil: int

    @property
    def key(self) -> str:
        return f"n{self.n_ceil}e{self.e_ceil}"

    def fits(self, n: int, e: int) -> bool:
        return n <= self.n_ceil and e <= self.e_ceil


class BucketPolicy:
    """An ordered ladder of shape buckets; ``pick`` returns the smallest
    bucket that fits (least padding)."""

    def __init__(self, buckets):
        if not buckets:
            raise ValueError("empty bucket ladder")
        self.buckets = sorted(buckets, key=lambda b: (b.n_ceil, b.e_ceil))

    @staticmethod
    def default(n_min: int = 128, e_min: int = 512,
                n_max: int = 4096, e_max: int = 65536) -> "BucketPolicy":
        """Doubling ladder from (n_min, e_min) to (n_max, e_max)."""
        out = []
        n, e = n_min, e_min
        while True:
            out.append(ShapeBucket(n, e))
            if n >= n_max and e >= e_max:
                break
            n, e = min(2 * n, n_max), min(2 * e, e_max)
        return BucketPolicy(out)

    @property
    def largest(self) -> ShapeBucket:
        return self.buckets[-1]

    def pick(self, n: int, e: int) -> ShapeBucket:
        for b in self.buckets:
            if b.fits(n, e):
                return b
        raise ValueError(
            f"request batch ({n} nodes, {e} edges) exceeds the largest "
            f"bucket {self.largest.key}")


@dataclass(frozen=True)
class PackGeom:
    """The static PCSR geometry of one bucket under one config.  Every
    subgraph packed through ``pack_subgraph`` with the same ``PackGeom``
    yields steering arrays of identical shapes and ``n_blocks`` chunk
    groups."""

    config: SpMMConfig
    n_rows: int
    n_blocks: int
    num_chunks: int
    K: int

    @staticmethod
    def from_bucket(bucket: ShapeBucket, config: SpMMConfig) -> "PackGeom":
        R = config.R
        n_rows = _round_up(bucket.n_ceil, R) + R   # +R: always-empty block
        n_panels = n_rows // config.V
        n_blocks = n_panels // config.W
        mean = -(-bucket.e_ceil // max(1, n_blocks - 1))
        K = max(SUBLANES, _round_up(mean, SUBLANES))
        num_chunks = n_blocks + -(-bucket.e_ceil // K)
        return PackGeom(config, n_rows, n_blocks, num_chunks, K)

    @property
    def num_slots(self) -> int:
        return self.num_chunks * self.K

    def bounds(self, cap: int | None = None) -> ScheduleBounds:
        """The work schedule's bounds over every batch packed into this
        geometry (``cap``: a smaller unit cap, to force split groups)."""
        return schedule_bounds(self.n_blocks, self.num_chunks, self.K, cap)


def pack_subgraph(csr: CSRMatrix, geom: PackGeom) -> PCSR:
    """Pack a (relabeled) subgraph into the bucket's fixed geometry:
    build at the bucket's pinned chunk capacity, then pad rows and
    chunks to the ceiling.  The result has zero empty blocks."""
    if csr.n_rows > geom.n_rows - geom.config.R:
        raise ValueError(
            f"subgraph ({csr.n_rows} rows) exceeds bucket rows "
            f"({geom.n_rows} incl. the reserved empty block)")
    p = build_pcsr(csr.indptr, csr.indices, csr.data,
                   csr.n_rows, csr.n_cols, geom.config, capacity=geom.K)
    return pad_pcsr(p, n_rows=geom.n_rows, n_cols=geom.n_rows,
                    num_chunks=geom.num_chunks)


def steering_arrays(padded: PCSR, device) -> Steering:
    """Steering of a bucket-padded PCSR on ``device`` — the operand of
    ``bucket_forward`` — with its chunk-group table and its unit table
    padded to the geometry's bounds."""
    return Steering.from_pcsr(padded, device, bounds=schedule_bounds(
        padded.n_blocks, padded.covered_num_chunks, padded.K))
