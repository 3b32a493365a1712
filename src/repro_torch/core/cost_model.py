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
``chunk_setup`` have no data-sheet counterpart and are 0 until a
calibration on the card fits them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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


class CostModel:
    """Caches per-(V,W) stats for one matrix; prices any config × dim.

    ``op`` is the operator priced: ``"spmm"``, ``"sddmm"``, or ``"gat"``
    — the attention pair, one fused SDDMM+softmax pass plus one SpMM
    aggregation pass, so ``best(..., op="gat")`` picks the config that
    minimises the pair.  ``H`` prices the per-head grids.  The unfused
    pipeline's price (``fused=False``) is not ported yet.
    """

    def __init__(self, csr: CSRMatrix, hardware: Hardware = H100):
        self.csr = csr
        self.hardware = hardware
        self._stats: dict[tuple[int, int], PCSRStats] = {}

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
             H: int = 1, epilogue: bool = False) -> float:
        """Seconds for one kernel pass (the analytic roofline total), or
        for the SDDMM + SpMM pair when ``op="gat"``."""
        if op == "gat":
            return (self.cost(dim, config, "sddmm", H=H).total
                    + self.cost(dim, config, "spmm", H=H).total)
        return self.cost(dim, config, op, H=H, epilogue=epilogue).total

    def best(self, dim: int, space, op: str = "spmm", *,
             H: int = 1) -> tuple[SpMMConfig, float]:
        best_cfg, best_t = None, np.inf
        for cfg in space:
            t = self.time(dim, cfg, op, H=H)
            if t < best_t:
                best_cfg, best_t = cfg, t
        return best_cfg, best_t
