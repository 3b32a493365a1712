"""Analytical cost model for the ParamSpMM kernel, hardware as a parameter.

It prices the exact chunk grid a configuration packs — per (V, W) block
populations come from ``pcsr_stats``, so every padding effect the paper
discusses is priced:

  * V padding (PR_V)      → more slots when vectors are half-empty;
  * S chunk padding       → slots = Σ_b ceil(cnt_b/K)·K;
  * B balanced schedule   → fewer padding slots, priced against the
                            per-chunk ``chunk_setup`` the finer split pays;
  * F dim-tile gap        → J·Dblk ≥ dim column waste;
  * W scatter granularity → output-block traffic ∝ blocks touched.

The formulas are the JAX package's; the constants are a ``Hardware``
argument.  ``H100`` is the default.  Its ``hbm_bw`` and ``flops`` are
NVIDIA data-sheet figures (H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s float32
outside the tensor cores), not measurements.  ``step_overhead`` and
``chunk_setup`` have no data-sheet counterpart and are 0.  A calibration
artifact (``core.calibrate``; the card's is
``configs/calibration_h100.json``) replaces all of them with
coefficients fitted to the card's measured kernel times: pass it as
``CostModel(csr, calibration=)`` or ``CostModel.from_calibration``.  The
default pick stays the data-sheet one.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.obs import decisions as _obs_decisions, trace as _obs_trace

from .pcsr import PCSRStats, SpMMConfig, pcsr_stats
from .sparse import CSRMatrix


@dataclass(frozen=True)
class Hardware:
    """The constants one pricing uses."""

    hbm_bw: float          # B/s, device memory
    flops: float           # FLOP/s of the unit the SpMM's MACs run on
    step_overhead: float   # s per grid step not hidden by overlap
    chunk_setup: float     # s per chunk setup not hidden by overlap
    dtype_bytes: int = 4


# Data-sheet figures (H100 SXM, 700 W); step_overhead/chunk_setup are
# placeholders until calibrated on the card.
H100 = Hardware(hbm_bw=3.35e12, flops=67e12, step_overhead=0.0,
                chunk_setup=0.0)
# The halo exchange's link rate (``halo_exchange_cost``), same data sheet:
# NVLink 4, 900 GB/s per GPU over both directions of its 18 links, so
# 450 GB/s into one GPU.  Not a measurement; a collective's fixed latency
# has no data-sheet figure and is 0, as the kernel overheads are.
NVLINK_BW = 450e9
COLLECTIVE_LATENCY = 0.0


@dataclass(frozen=True)
class PackSetup:
    """Host time of one full re-pack of a mutated graph, as ``fixed +
    per_nnz · nnz`` seconds: the live edge set to CSR, ``build_pcsr``,
    the view's ``Steering`` (group and work-unit tables) and its copy to
    the device, synchronised — what ``dynamic.DynamicGraph.repack`` costs
    before its next launch."""

    fixed: float           # s per re-pack
    per_nnz: float         # s per live nonzero


# Least-squares fit printed on the ``[dynamic pack setup]`` line of a
# full ``chip_smoke.py`` run (phase 18) on an NVIDIA H100 80GB HBM3 at
# 700.00 W: two synchronised re-packs each of the 131,072-node community
# graph cut to 16k, 32k, 64k and 131k nodes, 0.35M to 2.94M nonzeros,
# 78.7 to 876.8 ms (one outlier of 322.1 ms at 0.35M).  Four other runs
# of the phase on that machine, whose host is shared, fitted per_nnz from
# 2.87e-07 to 4.02e-07; the cost grows faster than linearly (sorts),
# which a line does not capture.
PACK_SETUP_H100 = PackSetup(fixed=2.165492e-02, per_nnz=2.775608e-07)


def pack_setup_seconds(nnz: int, setup: PackSetup = PACK_SETUP_H100
                       ) -> float:
    """Priced host time of one full re-pack of ``nnz`` live nonzeros."""
    return setup.fixed + setup.per_nnz * max(0, int(nnz))


@dataclass
class CostBreakdown:
    t_mem: float
    t_compute: float
    t_overhead: float
    bytes_gather: float
    bytes_meta: float
    bytes_out: float
    flops: float
    steps: int
    chunk_setups: int = 0

    @property
    def total(self) -> float:
        return max(self.t_mem, self.t_compute) + self.t_overhead

    @property
    def bytes_total(self) -> float:
        return self.bytes_gather + self.bytes_meta + self.bytes_out


def _head_dim(dim: int, heads: int) -> int:
    """Per-head feature width: multi-head layers split ``dim`` across
    heads, so head tiling runs H grids of d/H columns."""
    return max(1, -(-dim // heads))


def kernel_cost(stats: PCSRStats, dim: int, config: SpMMConfig,
                hw: Hardware = H100, *, heads: int = 1,
                epilogue: bool = False,
                residual: bool = False) -> CostBreakdown:
    """Price one SpMM under ⟨W,F,V,S,B⟩ given (V,W)-matched block stats.

    ``epilogue=True`` adds the fused-epilogue operand reads (per-row
    scale + per-feature bias); ``residual=True`` adds the dense (n, d)
    residual-addend read, one (R, Dblk) tile per (block, j).
    """
    if stats.V != config.V or stats.W != config.W:
        raise ValueError(f"stats (V={stats.V}, W={stats.W}) do not match "
                         f"{config}")
    dtype_bytes = hw.dtype_bytes
    C, K, slots = stats.chunks_and_slots(config.S, B=config.B)
    dblk = config.dblk
    d_head = _head_dim(dim, heads)
    J = -(-d_head // dblk)
    C *= heads
    n_blocks = stats.n_nonempty_blocks * heads
    steps = J * C * K
    # B-row gathers: one (1, Dblk) tile per step
    bytes_gather = steps * dblk * dtype_bytes
    # per-chunk metadata (vals block + colidx/lrow/trow scalars), per j pass
    bytes_meta = J * C * K * (config.V * 4 + 4 + 4)
    # output blocks written once per (j, block)
    bytes_out = J * n_blocks * config.R * dblk * dtype_bytes
    flops = 2.0 * steps * config.V * dblk
    if epilogue:
        bytes_meta += (n_blocks * config.R + J * n_blocks * dblk
                       ) * dtype_bytes
        flops += 3.0 * n_blocks * config.R * d_head
    if residual:
        bytes_meta += J * n_blocks * config.R * dblk * dtype_bytes
        flops += 1.0 * n_blocks * config.R * d_head
    return CostBreakdown(
        t_mem=(bytes_gather + bytes_meta + bytes_out) / hw.hbm_bw,
        t_compute=flops / hw.flops,
        t_overhead=steps * hw.step_overhead + J * C * hw.chunk_setup,
        bytes_gather=bytes_gather, bytes_meta=bytes_meta, bytes_out=bytes_out,
        flops=flops, steps=steps, chunk_setups=J * C)


def degraded_kernel_cost(dim: int, config: SpMMConfig, *, C: int, K: int,
                         n_blocks_visited: int, hw: Hardware = H100,
                         heads: int = 1, epilogue: bool = False,
                         residual: bool = False) -> CostBreakdown:
    """Price the grid a mutated ``dynamic.DynamicPCSR`` actually runs.

    ``kernel_cost`` prices the grid a fresh pack of the matrix would
    have; after slack-slot inserts, tombstoned deletes and appended delta
    chunks the live steering runs a larger one.  This takes the live
    extents (``C`` chunks of ``K`` slots; the distinct blocks they
    target, which bound the output traffic, fully deleted blocks
    included) and prices the same terms as ``kernel_cost`` on ``hw``, so
    a degraded and a fresh price compare like for like."""
    dtype_bytes = hw.dtype_bytes
    dblk = config.dblk
    d_head = _head_dim(dim, heads)
    J = -(-d_head // dblk)
    C = int(C) * heads
    n_blocks = int(n_blocks_visited) * heads
    steps = J * C * K
    bytes_gather = steps * dblk * dtype_bytes
    bytes_meta = J * C * K * (config.V * 4 + 4 + 4)
    bytes_out = J * n_blocks * config.R * dblk * dtype_bytes
    flops = 2.0 * steps * config.V * dblk
    if epilogue:
        bytes_meta += (n_blocks * config.R + J * n_blocks * dblk
                       ) * dtype_bytes
        flops += 3.0 * n_blocks * config.R * d_head
    if residual:
        bytes_meta += J * n_blocks * config.R * dblk * dtype_bytes
        flops += 1.0 * n_blocks * config.R * d_head
    return CostBreakdown(
        t_mem=(bytes_gather + bytes_meta + bytes_out) / hw.hbm_bw,
        t_compute=flops / hw.flops,
        t_overhead=steps * hw.step_overhead + J * C * hw.chunk_setup,
        bytes_gather=bytes_gather, bytes_meta=bytes_meta, bytes_out=bytes_out,
        flops=flops, steps=steps, chunk_setups=J * C)


def sddmm_cost(stats: PCSRStats, dim: int, config: SpMMConfig,
               hw: Hardware = H100, *, heads: int = 1) -> CostBreakdown:
    """Price one fused SDDMM(+softmax stats) under ⟨W,F,V,S,B⟩.

    Reduction-bound where the SpMM is scatter-bound: every step streams a
    (V, Dblk) query panel and the gathered (1, Dblk) key row but writes
    one score per slot plus two per-row softmax stats per block,
    independent of ``dim``.  ``heads`` prices H grids over the per-head
    dim, as in ``kernel_cost``.
    """
    if stats.V != config.V or stats.W != config.W:
        raise ValueError(f"stats (V={stats.V}, W={stats.W}) do not match "
                         f"{config}")
    dtype_bytes = hw.dtype_bytes
    C, K, _ = stats.chunks_and_slots(config.S, B=config.B)
    dblk = config.dblk
    d_head = _head_dim(dim, heads)
    J = -(-d_head // dblk)
    C *= heads
    n_blocks = stats.n_nonempty_blocks * heads
    steps = J * C * K
    # per step: the key-row gather (1, Dblk) + the query panel (V, Dblk)
    bytes_gather = steps * (1 + config.V) * dblk * dtype_bytes
    # colidx/lrow per slot + trow/init per chunk + the mask vals
    bytes_meta = C * K * 8 + C * 8 + C * config.V * K * dtype_bytes
    # scores once per slot; softmax stats once per block row
    bytes_out = (C * config.V * K
                 + 2 * n_blocks * config.R) * dtype_bytes
    # dot-product MACs + ~8 operations of exp/max per slot row
    flops = 2.0 * steps * config.V * dblk + 8.0 * C * K * config.V
    return CostBreakdown(
        t_mem=(bytes_gather + bytes_meta + bytes_out) / hw.hbm_bw,
        t_compute=flops / hw.flops,
        t_overhead=steps * hw.step_overhead + C * hw.chunk_setup,
        bytes_gather=bytes_gather, bytes_meta=bytes_meta, bytes_out=bytes_out,
        flops=flops, steps=steps, chunk_setups=C)


def unfused_bytes(stats: PCSRStats, dim: int, config: SpMMConfig,
                  op: str, dtype_bytes: int = H100.dtype_bytes, *,
                  heads: int = 1) -> float:
    """Device-memory bytes of the elementwise passes between kernels that
    the fused pipeline removes — the traffic side of ``unfused_penalty``,
    split out so a calibrated model prices it at its fitted stream rate.

    op="gat": the softmax-normalize pass between SDDMM and SpMM, ≈ 3
    slot-tensor traversals (read logits and row stats, write α, and the
    α the backward would keep).  op="spmm": the separate degree-norm /
    bias / activation pass over the (n, d) output, one read and one
    write.
    """
    C, K, _ = stats.chunks_and_slots(config.S, B=config.B)
    if op == "gat":
        slot_bytes = heads * C * config.V * K * dtype_bytes
        return 3.0 * slot_bytes
    if op == "spmm":
        out_bytes = heads * stats.n_rows * _head_dim(dim, heads) * dtype_bytes
        return 2.0 * out_bytes
    raise ValueError(f"no fusion penalty for op={op!r}")


def unfused_penalty(stats: PCSRStats, dim: int, config: SpMMConfig,
                    op: str, hw: Hardware = H100, *,
                    heads: int = 1) -> float:
    """Extra seconds the unfused pipeline pays over the fused one: the
    ``unfused_bytes`` round trips at ``hw``'s memory rate."""
    return unfused_bytes(stats, dim, config, op, hw.dtype_bytes,
                         heads=heads) / hw.hbm_bw


class CostModel:
    """Caches per-(V,W) stats for one matrix; prices any config × dim.

    ``op`` is the operator priced: ``"spmm"``, ``"sddmm"``, or ``"gat"``
    — the attention pair, one fused SDDMM+softmax pass plus one SpMM
    aggregation pass, so ``best(..., op="gat")`` picks the config that
    minimises the pair.  ``H`` prices the per-head grids.
    ``fused=False`` adds the elementwise passes the fusion removes
    (``unfused_penalty``).

    ``calibration`` (a ``core.calibrate.CalibrationResult``; load one
    with ``from_calibration``) prices the same grid extents (bytes,
    MACs, steps, chunk setups of ``cost()``) through coefficients fitted
    to measured kernel time instead of ``hardware``'s constants.
    """

    def __init__(self, csr: CSRMatrix, hardware: Hardware = H100,
                 calibration=None):
        self.csr = csr
        self.hardware = hardware
        self.calibration = calibration
        self._stats: dict[tuple[int, int], PCSRStats] = {}

    @classmethod
    def from_calibration(cls, csr: CSRMatrix, path) -> "CostModel":
        """Cost model priced by a saved calibration artifact (a JSON path
        or an already-loaded ``CalibrationResult``)."""
        from .calibrate import CalibrationResult
        cal = (path if isinstance(path, CalibrationResult)
               else CalibrationResult.load(path))
        return cls(csr, calibration=cal)

    def stats(self, V: int, W: int) -> PCSRStats:
        key = (V, W)
        if key not in self._stats:
            self._stats[key] = pcsr_stats(self.csr.indptr, self.csr.indices,
                                          self.csr.n_rows, self.csr.n_cols,
                                          V, W)
        return self._stats[key]

    def cost(self, dim: int, config: SpMMConfig, op: str = "spmm", *,
             H: int = 1, epilogue: bool = False,
             residual: bool = False) -> CostBreakdown:
        st = self.stats(config.V, config.W)
        if op == "spmm":
            return kernel_cost(st, dim, config, self.hardware, heads=H,
                               epilogue=epilogue, residual=residual)
        if op == "sddmm":
            return sddmm_cost(st, dim, config, self.hardware, heads=H)
        raise ValueError(f"no single-kernel breakdown for op={op!r}")

    def time(self, dim: int, config: SpMMConfig, op: str = "spmm", *,
             H: int = 1, fused: bool = True,
             epilogue: bool = False) -> float:
        """Seconds for one kernel pass, or for the SDDMM + SpMM pair when
        ``op="gat"``.  ``epilogue=True`` prices a fused-epilogue SpMM;
        with ``fused=False`` the post-ops run as separate passes instead,
        so the kernel is priced without the epilogue and the elementwise
        passes' penalty is added."""
        if op == "gat":
            t = (self._price(self.cost(dim, config, "sddmm", H=H), "sddmm")
                 + self._price(self.cost(dim, config, "spmm", H=H), "spmm"))
        else:
            t = self._price(self.cost(dim, config, op, H=H,
                                      epilogue=epilogue and fused), op)
        if not fused and op in ("gat", "spmm"):
            st = self.stats(config.V, config.W)
            if self.calibration is None:
                t += unfused_penalty(st, dim, config, op, self.hardware,
                                     heads=H)
            else:
                t += self.calibration.stream_seconds(
                    unfused_bytes(st, dim, config, op,
                                  self.hardware.dtype_bytes, heads=H),
                    hbm_bw=self.hardware.hbm_bw)
        return t

    def _price(self, bd: CostBreakdown, op: str) -> float:
        """Seconds for one kernel pass: the analytic roofline total, or,
        when calibrated, the fitted linear model over the same grid
        extents (``calibrate.breakdown_features``)."""
        if self.calibration is None:
            return bd.total
        return self.calibration.price(bd, op)

    def fusion_savings(self, dim: int, config: SpMMConfig,
                       op: str = "gat", *, H: int = 1) -> float:
        """Seconds the fused pipeline saves over the unfused one; for
        ``op="spmm"`` the fused side pays the epilogue operand reads, the
        unfused side the separate elementwise passes."""
        return (self.time(dim, config, op, H=H, fused=False)
                - self.time(dim, config, op, H=H, fused=True,
                            epilogue=op == "spmm"))

    def best(self, dim: int, space, op: str = "spmm", *, H: int = 1,
             fused: bool = True) -> tuple[SpMMConfig, float]:
        """The cheapest config of ``space`` (the first on a tie) and its
        price; recorded in the decision log while tracing is on."""
        best_cfg, best_t = None, np.inf
        scored = []
        for cfg in space:
            t = self.time(dim, cfg, op, H=H, fused=fused)
            scored.append((cfg, t))
            if t < best_t:
                best_cfg, best_t = cfg, t
        if _obs_trace.trace_enabled() and best_cfg is not None:
            _obs_decisions.record_decision(
                self.csr, source="cost_model", op=op, dim=dim, heads=H,
                chosen=best_cfg, predicted_seconds=best_t,
                candidates=scored, calibration=self.calibration)
        return best_cfg, best_t


def useful_flops(nnz: int, dim: int) -> float:
    """MAC count of the mathematical SpMM (2·nnz·dim)."""
    return 2.0 * nnz * dim


# --------------------------------------------------- distributed terms


def halo_exchange_cost(gathered_rows: int, dim: int, dtype_bytes: int = 4,
                       link_bw: float = NVLINK_BW,
                       latency: float = COLLECTIVE_LATENCY) -> float:
    """Seconds one compacted halo ``all_gather`` keeps a GPU's links
    busy: every rank receives the full ``(P·max_send, dim)`` send buffer,
    so the time is its bytes over the inbound link rate plus a fixed
    collective latency.  The overlap path (``dist.DistGraph(overlap=
    True)``) hides this behind the shard-local SpMM."""
    return (gathered_rows * dim * dtype_bytes) / link_bw + latency


def overlap_exposed_cost(local_time: float, halo_time: float,
                         exchange_time: float) -> float:
    """Predicted per-shard time under the overlap decomposition: the
    gather runs while the local SpMM does (the longer one bounds), then
    the halo SpMM runs on the landed rows.  The serialized schedule takes
    ``local_time + halo_time + exchange_time``."""
    return max(local_time, exchange_time) + halo_time
