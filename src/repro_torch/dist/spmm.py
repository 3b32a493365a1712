"""Distributed SpMM / GAT message over a row-partitioned graph.

``DistGraph`` turns one global adjacency into per-shard PCSR operators:
the rows are 1D-partitioned (``partition.py``) and each shard's local CSR
gets its *own* ⟨W,F,V,S⟩ configuration, chosen by ``CostModel.best`` (or
a trained decider) on that shard's features and priced per head count
for a multi-head GAT.

Execution is multi-controller: one process per shard (a *rank*), over a
``torch.distributed`` process group (``comm.py``).  The host plan —
partition, halo maps, the configs of every shard — is computed the same
way on every rank (``DistGraph.configs`` is the full list); each rank
then packs and stages only its own shard (``packing.py``) and runs its
own kernels at its own shapes and config.  Node-aligned tensors are
local: a rank holds its ``(rows_pad, d)`` block (``pad``), and every
operator takes and returns local blocks.

1. **halo exchange** (``halo.py``) — one compacted ``all_gather`` brings
   the remote source rows a shard needs; they follow the local block to
   form the extended column space ``[local rows_pad | halo max_halo]``
   the shard's PCSR indexes.
2. **per-shard compute** — the port's single-device autograd operators
   on that extended space: ``core.engine``'s SpMM and fused SpMM on the
   shard's PCSR and its transpose, and its GAT message (``gat.py``).
   Their backward gives the gradient over the extended space; the
   exchange's own backward (``HaloExchange``) sends its halo block home
   (scatter → ``reduce_scatter`` → local add).  Autograd composes the
   two, so no per-shard backward is written here.

Dense layers, GCN's scale, GIN's ``(1+ε)h`` and GAT's projections are
row-wise, and row partitioning keeps a row's edges on one shard, so the
edge softmax needs no communication either.

``DistGraph(overlap=True)`` runs the SpMM paths as ``A_loc·B + A_halo·
halo`` (``partition.split_local_halo``), each part under its own config:
the ``all_gather`` is launched, the local SpMM runs while it is in
flight, then the halo SpMM runs on the landed rows.  The backward
launches the halo gradients' ``reduce_scatter`` before the local
transpose SpMM.  ``fused`` then applies its epilogue after the add.

Kernels or plain versions: as everywhere in the port, by the device of
the tensors (CUDA kernels on the card, their plain versions on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cost_model import (H100, CostModel, Hardware,
                                         halo_exchange_cost,
                                         overlap_exposed_cost)
from repro_torch.core.engine import apply_epilogue
from repro_torch.core.features import extract_features
from repro_torch.core.pcsr import SpMMConfig, config_space
from repro_torch.core.sparse import CSRMatrix
from repro_torch.device import check_backend
from repro_torch.obs import metrics as _obs_metrics, trace as _obs_trace

from .halo import HaloPlan, HaloSpec, build_halo, halo_exchange
from .packing import ShardPack, pack_shard
from .partition import RowPartition, partition_csr, split_local_halo


class _OverlapSpMM(torch.autograd.Function):
    """``A_loc·B + A_halo·halo(B)`` with the exchange in flight during the
    local SpMM; backward, the halo transpose SpMM, its ``reduce_scatter``
    in flight during the local transpose SpMM."""

    @staticmethod
    def forward(ctx, B, g: "DistGraph"):
        from repro_torch.kernels.paramspmm.ops import paramspmm
        pack, plan = g.pack, g.halo_plan
        pending = plan.start(B)
        out = paramspmm(pack.loc.pcsr, B)
        halo = plan.finish(pending.wait())
        ctx.g = g
        return out + paramspmm(pack.halo.pcsr, halo)

    @staticmethod
    def backward(ctx, dC):
        from repro_torch.kernels.paramspmm.ops import paramspmm
        pack, plan = ctx.g.pack, ctx.g.halo_plan
        dC = dC.contiguous()
        pending = plan.scatter_start(paramspmm(pack.halo.pcsr_t, dC))
        d_loc = paramspmm(pack.loc.pcsr_t, dC)
        return plan.scatter_finish(pending.wait(), d_loc), None


class DistGraph:
    """Partitioned graph operator: per-shard adaptive PCSR, one shard per
    rank.

    Configuration resolution per shard: explicit ``configs`` (one or a
    per-shard list) > ``decider`` prediction on the shard's features >
    ``CostModel.best`` on the shard's local CSR with ``op``/``heads``
    pricing on ``hardware`` (or ``calibration``) — so a power-law
    graph's hub shard and tail shards pick *different* ⟨W,F,V,S⟩.

    Parameters
    ----------
    csr : CSRMatrix
        The global (square) adjacency; rows are destination nodes.
    dim : int
        Feature width the configs are priced for.
    n_parts : int
        Number of row shards = ranks of ``group``.
    strategy : ``"balanced"`` (equal-nnz boundaries) or ``"contiguous"``.
    calibration : optional ``core.calibrate.CalibrationResult`` (or
        artifact path) to price through instead of ``hardware``.
    heads : head count the configs are priced for.
    overlap : run the SpMM paths under the local/halo decomposition (see
        the module docstring); ``gat_message`` always runs the joint path.
    backend : the JAX package's keyword.  The port picks kernels or
        plain versions by device: ``"pallas"`` (its kernels) runs the
        CUDA kernels on the card and their plain versions on the CPU;
        ``"engine"`` (its plain traversal) is the CPU path and raises on
        a CUDA device.
    interpret : the JAX package's keyword; the port has no interpret
        mode (a CPU device takes the plain versions).
    op : operator the configs are priced for (``"spmm"`` | ``"sddmm"`` |
        ``"gat"``).
    hardware : the cost model's constants (default the data-sheet H100).
    group : the ``torch.distributed`` process group (default the world);
        its rank is this process's shard.
    device : this rank's device (default CUDA).

    Construction computes the host plan.  The rank's own pack is built
    and staged then too when a process group is initialised, else at the
    first operator call; without a group the plan is all there is.
    """

    def __init__(self, csr: CSRMatrix, dim: int, n_parts: int, *,
                 strategy: str = "balanced",
                 configs=None,
                 decider=None,
                 calibration=None,
                 mesh=None,
                 backend: str | None = None,
                 interpret: bool = True,
                 op: str = "spmm",
                 heads: int = 1,
                 overlap: bool = False,
                 max_f: int = 4,
                 hardware: Hardware = H100,
                 group=None,
                 device=None):
        if mesh is not None:
            raise ValueError("the port has no mesh: each rank of the "
                             "process group (group=) holds one shard")
        check_backend(backend)
        self.csr = csr
        self.dim = dim
        self.backend = backend
        self.interpret = interpret
        self.heads = heads
        self.overlap = overlap
        self.hardware = hardware
        self.group = group
        self._device = device
        self.part: RowPartition = partition_csr(csr, n_parts, strategy)
        self.halo: HaloSpec = build_halo(self.part)

        if calibration is not None and not hasattr(calibration, "price"):
            from repro_torch.core.calibrate import CalibrationResult
            calibration = CalibrationResult.load(calibration)
        self.calibration = calibration
        cost = lambda m: CostModel(m, hardware, calibration=calibration)

        space = config_space(dim, max_f)
        self.predicted_times: list = []
        if configs is None:
            if decider is not None:
                with _obs_trace.span("dist.select_configs", picker="decider",
                                     n_parts=n_parts):
                    self.configs = [
                        decider.predict(extract_features(s.csr), dim)
                        for s in self.part.shards]
            else:
                self.configs = []
                with _obs_trace.span("dist.select_configs",
                                     picker="cost_model", n_parts=n_parts):
                    for s in self.part.shards:
                        cfg, t = cost(s.csr).best(dim, space, op=op, H=heads)
                        self.configs.append(cfg)
                        self.predicted_times.append(t)
        elif isinstance(configs, SpMMConfig):
            self.configs = [configs] * n_parts
        else:
            self.configs = list(configs)
            if len(self.configs) != n_parts:
                raise ValueError("configs list must have one entry per shard")

        # overlap: local + halo sub-matrices per shard, each with its own
        # config (the halo part of a power-law shard is much sparser)
        self.overlap_configs: list = []
        self._split_csrs: list = []
        if overlap:
            for i, s in enumerate(self.part.shards):
                loc, hal = split_local_halo(s, self.part)
                self._split_csrs.append((loc, hal))
                if configs is not None:
                    lc = hc = self.configs[i]
                elif decider is not None:
                    lc = decider.predict(extract_features(loc), dim)
                    hc = decider.predict(extract_features(hal), dim)
                else:
                    lc, _ = cost(loc).best(dim, space, H=heads)
                    hc, _ = cost(hal).best(dim, space, H=heads)
                self.overlap_configs.append((lc, hc))
            if _obs_trace.trace_enabled():
                # priced decomposition per shard: the exchange time the
                # schedule hides vs what stays exposed
                exch = halo_exchange_cost(self.halo.gathered_rows, dim)
                _obs_metrics.gauge("halo_exchange_priced_seconds").set(exch)
                for i, ((loc, hal), (lc, hc)) in enumerate(
                        zip(self._split_csrs, self.overlap_configs)):
                    tl = cost(loc).time(dim, lc, H=heads)
                    th = cost(hal).time(dim, hc, H=heads)
                    _obs_metrics.gauge("overlap_exposed_seconds").set(
                        overlap_exposed_cost(tl, th, exch), shard=i)
                    _obs_metrics.gauge("overlap_serialized_seconds").set(
                        tl + th + exch, shard=i)

        self.rank = None
        self.device = None
        self.comm = None
        self.pack: ShardPack | None = None
        self.halo_plan: HaloPlan | None = None
        self._gat_fns: dict = {}
        if dist.is_initialized():
            self._bind()

    # ------------------------------------------------------------ rank
    def _bind(self):
        """Join the process group: this rank's pack, on its device."""
        if self.pack is not None:
            return
        from repro_torch.device import resolve_device
        from . import comm as _comm
        comm = _comm.Comm(self.group)
        if comm.world != self.part.n_parts:
            raise ValueError(f"{self.part.n_parts} shards need a process "
                             f"group of {self.part.n_parts} ranks, not "
                             f"{comm.world}")
        device = resolve_device(self._device)
        check_backend(self.backend, device)
        r = comm.rank
        split = split_configs = None
        if self.overlap:
            split, split_configs = (self._split_csrs[r],
                                    self.overlap_configs[r])
        with _obs_trace.span("dist.pack", n_parts=self.part.n_parts, rank=r):
            pack = pack_shard(self.part.shards[r].csr, self.configs[r],
                              device, split=split,
                              split_configs=split_configs)
        self.rank, self.device, self.comm = r, device, comm
        self.halo_plan = HaloPlan(self.halo, r, self.part.rows_pad, comm,
                                  device)
        self.pack = pack

    @property
    def shard(self):
        """This rank's ``partition.Shard``."""
        self._bind()
        return self.part.shards[self.rank]

    @property
    def config(self) -> SpMMConfig:
        """This rank's config."""
        self._bind()
        return self.configs[self.rank]

    # ---------------------------------------------------------- layout
    def pad(self, x):
        """Global ``(n_global, ...)`` → this rank's ``(rows_pad, ...)``
        block, zeros on the padded rows, on the rank's device."""
        s = self.shard
        x = torch.as_tensor(x)
        out = x.new_zeros((self.part.rows_pad,) + tuple(x.shape[1:]),
                          device=self.device)
        out[:s.n_local_rows] = x[s.start:s.stop].to(self.device)
        return out

    def unpad(self, x):
        """This rank's ``(rows_pad, ...)`` block → the global
        ``(n_global, ...)`` tensor on every rank (an ``all_gather``: every
        rank must call it).  Not differentiable."""
        self._bind()
        full = self.comm.all_gather(x.detach())
        idx = self.part.pad_position(np.arange(self.part.n_global))
        return full.index_select(0, torch.as_tensor(idx, device=x.device))

    def pad_heads(self, x):
        """``(H, n_global, d)`` → this rank's ``(H, rows_pad, d)``."""
        x = torch.as_tensor(x)
        return self.pad(x.transpose(0, 1)).transpose(0, 1).contiguous()

    def unpad_heads(self, x):
        """This rank's ``(H, rows_pad, d)`` → ``(H, n_global, d)`` on every
        rank (a collective, as ``unpad``)."""
        y = self.unpad(x.transpose(0, 1).contiguous())
        return y.transpose(0, 1).contiguous()

    # -------------------------------------------------------- dynamics
    def refresh(self, new_csr: CSRMatrix, *, threshold=None):
        """Swap in a mutated adjacency over the same nodes, re-packing
        only the shards whose edges changed (this rank's own, if it did);
        per-shard config re-pick on drift past ``threshold``.  Every rank
        must call it with the same ``new_csr``.  Returns a
        ``ShardRefreshReport`` — see ``repro_torch.dynamic.dist``."""
        from repro_torch.dynamic.dist import refresh_dist_graph
        return refresh_dist_graph(self, new_csr, threshold=threshold)

    # ------------------------------------------------------- operators
    def _extended(self, B):
        """``[B | halo(B)]``: the shard's extended operand."""
        return torch.cat([B, halo_exchange(B, self.halo_plan)], dim=0)

    def spmm(self, B):
        """``C = A·B`` on this rank's rows: ``(rows_pad, d)`` in and out,
        differentiable (backward on the transpose PCSR, halo gradients
        sent home)."""
        self._bind()
        if self.overlap:
            return _OverlapSpMM.apply(B, self)
        return self.pack.op(self._extended(B))

    __call__ = spmm

    def fused(self, B, scale=None, bias=None, activation: str = "none",
              residual=None):
        """Epilogue-fused aggregation ``act(scale ⊙ (A·B) + bias +
        residual)`` on this rank's rows (``scale`` ``(rows_pad,)``,
        ``residual`` ``(rows_pad, d)``): the epilogue runs in the SpMM
        kernel; under ``overlap`` it runs after the local + halo add.
        Differentiable in ``B``, ``bias`` and ``residual``; the gradient
        of ``bias`` is this rank's sum (the caller's gradient reduction
        adds the ranks)."""
        self._bind()
        if self.overlap:
            return apply_epilogue(_OverlapSpMM.apply(B, self), scale, bias,
                                  activation, residual=residual)
        return self.pack.op.fused(self._extended(B), scale=scale, bias=bias,
                                  activation=activation, residual=residual)

    def gat_message(self, Q, K, Vf, *, slope: float = 0.2):
        """Distributed GAT attention message on this rank's rows: ``(n,
        d)`` operands single-head, ``(H, n, d)`` stacks every head in the
        same launches (``gat.py``)."""
        from .gat import dist_gat
        self._bind()
        return dist_gat(self, Q, K, Vf, slope=slope)


# ------------------------------------------------------ functional API
def dist_spmm(graph: DistGraph, B):
    """``C = A·B`` over a partitioned graph on this rank's rows (see
    ``DistGraph.spmm``)."""
    return graph.spmm(B)


def dist_gat_message(graph: DistGraph, Q, K, Vf, *, slope: float = 0.2):
    """Distributed SDDMM → LeakyReLU → edge softmax → SpMM message on
    this rank's rows (see ``gat.py``)."""
    return graph.gat_message(Q, K, Vf, slope=slope)
