"""Bucket-keyed steering-pack cache.

A cache entry (``BucketPack``) is everything request-independent about a
bucket: the decider- or cost-model-picked ⟨W,F,V,S,B⟩ config and the static
``PackGeom`` derived from it, which also fixes the kernel's grid (one
chunk group per output block, ``geom.n_blocks``).  The pick runs ONCE
per bucket, on the first batch that lands in it, and is amortized across
every later request.  The kernel's group table is not part of the entry:
where each group's chunks start depends on the batch (LPT order,
coverage and filler chunks), so ``steering_arrays`` builds it with each
batch's pack, on the host, in O(chunks).

Hits/misses/evictions are plain attributes (always on) mirrored into
``repro_torch.obs`` counters (``serve_cache_hits_total`` /
``serve_cache_misses_total`` / ``serve_cache_evictions_total``) when
tracing is active.  Capacity-bounded LRU: evicting a bucket drops its
config pick, not correctness — the next miss re-picks.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

from repro_torch.core.cost_model import H100, Hardware
from repro_torch.core.pcsr import SpMMConfig
from repro_torch.core.sparse import CSRMatrix
from repro_torch.obs import metrics as _metrics
from repro_torch.pipeline import pick_config

from .bucket import PackGeom, ShapeBucket


@dataclass(frozen=True)
class BucketPack:
    """Amortized per-bucket state: the picked config + static geometry."""

    bucket: ShapeBucket
    config: SpMMConfig
    geom: PackGeom


class SteeringPackCache:
    """LRU cache ``ShapeBucket → BucketPack``.

    ``dim`` is the widest layer of the served model (the config pick's
    embedding-dim argument); ``op`` steers the cost model ("spmm" for
    GCN/GIN, "gat" for attention, priced as the SDDMM + SpMM pair);
    ``heads`` prices multi-head attention's head-tiled grids;
    ``hardware`` the constants it prices with; ``decider`` (a trained
    ``core.decider.SpMMDecider``) short-circuits the cost model.
    """

    def __init__(self, *, dim: int, capacity: int = 8, op: str = "spmm",
                 heads: int = 1, hardware: Hardware = H100, decider=None):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.dim = dim
        self.capacity = capacity
        self.op = op
        self.heads = heads
        self.hardware = hardware
        self.decider = decider
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._entries: OrderedDict[ShapeBucket, BucketPack] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, bucket: ShapeBucket, csr: CSRMatrix) -> BucketPack:
        """The bucket's pack, picking a config from ``csr`` on a miss."""
        entry = self._entries.get(bucket)
        if entry is not None:
            self._entries.move_to_end(bucket)
            self.hits += 1
            _metrics.counter("serve_cache_hits_total").inc(bucket=bucket.key)
            return entry
        self.misses += 1
        _metrics.counter("serve_cache_misses_total").inc(bucket=bucket.key)
        config = pick_config(csr, self.dim, decider=self.decider,
                             op=self.op, heads=self.heads,
                             hardware=self.hardware)
        entry = BucketPack(bucket, config, PackGeom.from_bucket(bucket,
                                                                config))
        self._entries[bucket] = entry
        if len(self._entries) > self.capacity:
            evicted, _ = self._entries.popitem(last=False)
            self.evictions += 1
            _metrics.counter("serve_cache_evictions_total").inc(
                bucket=evicted.key)
        return entry

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
