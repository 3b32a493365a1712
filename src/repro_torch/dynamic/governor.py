"""The re-pack governor: when does a degraded layout stop being worth it?

After every mutation batch the governor reads cheap live stats of the
:class:`~repro_torch.dynamic.pcsr.DynamicPCSR` (chunk count, visited
blocks) and prices three futures on ``hardware``:

* **none** — keep running the degraded steering.  Priced by
  ``degraded_kernel_cost`` over the live grid (the chunks that actually
  run, delta chunks and tombstoned slack included).
* **reselect** — re-pick ``F`` on the existing layout.  ``F`` only tiles
  the feature dim, so it changes no steering array; V/W/S/B changes need
  a re-pack and are not offered here.
* **repack** — ``build_pcsr`` from the live edge set under a fresh
  ``CostModel.best`` pick, charged ``pack_setup_seconds(nnz,
  pack_setup) / amortize_steps`` on top of the fresh layout's priced
  time, so a re-pack fires only when the degradation pays it back
  within the amortisation horizon.

Drift comes in through ``obs.check_drift`` against the snapshot taken at
the last (re-)pack, and every verdict goes to the decision log
(``source="governor"``), the ``governor_decisions_total{action}`` counter
and a ``governor_decision`` instant while tracing.

The bound this keeps: results are exact at every moment (the layout
always encodes the live edge set), and the degraded layout's priced time
never exceeds ``slack ×`` the best fresh layout's plus the amortised
re-pack, because crossing that line returns ``action="repack"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.cost_model import (H100, PACK_SETUP_H100, CostModel,
                                         Hardware, PackSetup,
                                         degraded_kernel_cost,
                                         pack_setup_seconds)
from repro_torch.core.pcsr import SpMMConfig, config_space
from repro_torch.obs import metrics as _obs_metrics, trace as _obs_trace
from repro_torch.obs.decisions import (DecisionRecord, DriftAdvisory,
                                       check_drift, graph_snapshot,
                                       record_decision)

from .pcsr import DynamicPCSR


@dataclass
class GovernorDecision:
    """One governor verdict after a mutation batch."""

    action: str                       # "none" | "reselect" | "repack"
    reason: str
    config: SpMMConfig                # config after the action
    degraded_seconds: float           # priced step time, live layout
    fresh_seconds: float              # priced step time, best fresh pack
    repack_amortized_seconds: float   # pack_setup / amortize_steps
    advisory: Optional[DriftAdvisory] = None


class RepackGovernor:
    """Drives do-nothing / re-select / re-pack for one ``DynamicPCSR``.

    ``slack`` is the tolerated priced degradation factor (1.25: the
    degraded layout may price up to 25% over the amortised fresh
    alternative before a re-pack fires); ``amortize_steps`` the number of
    SpMM steps a re-pack's host cost is spread over; ``drift_threshold``
    goes to ``check_drift`` (scalar, per-feature dict, or None for the
    ``$REPRO_DRIFT_THRESHOLD`` hook).  ``hardware`` prices the kernels
    (and the fresh picks, through ``CostModel``) unless ``calibration``
    is given; ``pack_setup`` prices a re-pack.
    """

    def __init__(self, dim: int, *, op: str = "spmm", heads: int = 1,
                 space=None, calibration=None, slack: float = 1.25,
                 amortize_steps: int = 100, drift_threshold=None,
                 hardware: Hardware = H100,
                 pack_setup: PackSetup = PACK_SETUP_H100):
        self.dim = dim
        self.op = op
        self.heads = heads
        self.space = space
        self.calibration = calibration
        self.slack = float(slack)
        self.amortize_steps = int(amortize_steps)
        self.drift_threshold = drift_threshold
        self.hardware = hardware
        self.pack_setup = pack_setup
        self._baseline: Optional[DecisionRecord] = None

    # ------------------------------------------------------------ pricing
    def _price_degraded(self, dyn: DynamicPCSR,
                        config: SpMMConfig) -> float:
        """Priced seconds of the live degraded grid under ``config``: C
        and K from storage, not from a hypothetical fresh pack."""
        bd = degraded_kernel_cost(
            self.dim, config, C=dyn.num_chunks, K=dyn.K,
            n_blocks_visited=dyn.n_visited_blocks, hw=self.hardware,
            heads=self.heads)
        if self.calibration is None:
            return bd.total
        return self.calibration.price(bd, "spmm")

    def _amortized_repack(self, dyn: DynamicPCSR) -> float:
        return (pack_setup_seconds(dyn.nnz, self.pack_setup)
                / max(1, self.amortize_steps))

    def rebaseline(self, dyn: DynamicPCSR, config: SpMMConfig) -> None:
        """Record the layout's feature snapshot and priced time: at
        construction and after every re-pack, so drift is measured
        against the graph the current layout was packed for."""
        self._baseline = DecisionRecord(
            source="governor", op=self.op, dim=self.dim, heads=self.heads,
            chosen=config.astuple(),
            predicted_seconds=self._price_degraded(dyn, config),
            topk=[], snapshot=graph_snapshot(dyn.to_csr()),
            calibration=None)

    # ----------------------------------------------------------- verdicts
    def evaluate(self, dyn: DynamicPCSR,
                 config: SpMMConfig) -> GovernorDecision:
        """Price the degraded layout against a fresh pack and decide."""
        if self._baseline is None:
            self.rebaseline(dyn, config)
        t_deg = self._price_degraded(dyn, config)
        amort = self._amortized_repack(dyn)
        csr = dyn.to_csr()
        advisory = check_drift(csr, record=self._baseline,
                               threshold=self.drift_threshold)
        # fast path: no drift and the degraded price still within slack
        # of the baseline price — no config sweep
        base_t = self._baseline.predicted_seconds or t_deg
        if advisory is None and t_deg <= self.slack * base_t:
            return self._record(GovernorDecision(
                "none", "no drift; degraded price within slack of the "
                "packed baseline", config, t_deg, base_t, amort))
        space = self.space or config_space(self.dim)
        model = CostModel(csr, self.hardware, calibration=self.calibration)
        best_cfg, t_fresh = model.best(self.dim, space, op=self.op,
                                       H=self.heads)
        if t_deg > self.slack * (t_fresh + amort):
            return self._record(GovernorDecision(
                "repack",
                f"degraded layout priced {t_deg / max(t_fresh, 1e-30):.2f}×"
                f" the best fresh pack (+ amortized re-pack cost)",
                best_cfg, t_deg, t_fresh, amort, advisory))
        # the layout is still worth keeping, but F (and only F) can be
        # re-picked without re-packing
        f_space = {c.F for c in space if (c.V, c.W, c.S, c.B) ==
                   (config.V, config.W, config.S, config.B)}
        best_f, t_best_f = config, t_deg
        for f in sorted(f_space):
            cand = config.replace(F=f)
            t = self._price_degraded(dyn, cand)
            if t < t_best_f:
                best_f, t_best_f = cand, t
        if best_f != config:
            return self._record(GovernorDecision(
                "reselect",
                f"F={best_f.F} prices {t_best_f / max(t_deg, 1e-30):.2f}× "
                f"the current F={config.F} on the same steering arrays",
                best_f, t_best_f, t_fresh, amort, advisory))
        reason = ("drift advisory fired but the degraded layout still "
                  "prices within slack" if advisory is not None else
                  "degraded price within slack of the best fresh pack")
        return self._record(GovernorDecision(
            "none", reason, config, t_deg, t_fresh, amort, advisory))

    def _record(self, dec: GovernorDecision) -> GovernorDecision:
        _obs_metrics.counter("governor_decisions_total").inc(
            action=dec.action)
        if _obs_trace.trace_enabled():
            record_decision(
                source="governor", op=self.op, dim=self.dim,
                heads=self.heads, chosen=dec.config,
                predicted_seconds=dec.degraded_seconds,
                snapshot={"action": dec.action,
                          "degraded_seconds": dec.degraded_seconds,
                          "fresh_seconds": dec.fresh_seconds,
                          "repack_amortized_seconds":
                              dec.repack_amortized_seconds,
                          "drifted": sorted(dec.advisory.drifted)
                          if dec.advisory else []})
            _obs_trace.instant("governor_decision", cat="decision",
                               action=dec.action, reason=dec.reason)
        return dec
