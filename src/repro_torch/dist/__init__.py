"""Distributed graph operators: row-partitioned PCSR over
``torch.distributed``, one shard per rank, each with its own adaptive
⟨W,F,V,S⟩ configuration.

* ``partition`` — 1D row partitioning (contiguous / balanced-nnz) into
  per-shard local CSRs with compact halo column maps, plus the
  local/halo edge split the overlap path executes;
* ``halo``      — compacted halo feature exchange and its gradient
  scatter-back, one ``torch.autograd.Function``;
* ``comm``      — process groups, spawn, backend and device choice, and
  the collectives (gloo on CUDA tensors staged through pinned host
  buffers);
* ``packing``   — each rank's own pack of its shard;
* ``spmm``      — ``DistGraph`` / ``dist_spmm``: the single-device
  autograd operators on each shard's extended column space, with
  optional halo/compute overlap (``DistGraph(overlap=True)``);
* ``gat``       — ``dist_gat_message``: the multi-head GAT message with
  the joint K/Vf exchange, two kernel launches per rank forward.
"""
from .halo import (HaloExchange, HaloPlan, HaloSpec, build_halo,
                   halo_exchange, halo_scatter_back)
from .packing import ShardPack, pack_shard
from .partition import (RowPartition, Shard, partition_bounds,
                        partition_csr, split_local_halo, unpartition_rows)
from .spmm import DistGraph, dist_gat_message, dist_spmm

__all__ = [
    "RowPartition", "Shard", "partition_bounds", "partition_csr",
    "split_local_halo", "unpartition_rows",
    "HaloSpec", "build_halo", "halo_exchange", "halo_scatter_back",
    "HaloExchange", "HaloPlan",
    "DistGraph", "dist_spmm", "dist_gat_message",
    "ShardPack", "pack_shard",
]
