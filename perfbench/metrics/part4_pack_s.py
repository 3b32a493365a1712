"""Seconds of rank 0's pack in the partitioned GCN (the partition, halo
maps, every shard's config pick, its own shard's PCSRs): ``pack_s``'s
reading."""
from perfbench.metrics.pack_s import read  # noqa: F401
