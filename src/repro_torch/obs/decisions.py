"""Structured decision log + input-drift advisories.

Every config pick — ``CostModel.best``, ``SpMMDecider.predict``,
``oracle_search`` — records *why* it chose its ⟨W,F,V,S,B⟩: the input
feature snapshot it decided on, the top-k priced/measured candidates,
the chosen config, and the calibration artifact id.  Records live on a
process-wide log (exported under ``repro_decisions`` in the trace JSON)
and survive ``stop_tracing`` so ``check_drift(csr)`` can later compare a
record's snapshot against the graph's *current* stats: when any tracked
feature moved by more than ``DRIFT_THRESHOLD`` relative, it returns a
``DriftAdvisory`` recommending re-selection.

Core modules (``repro_torch.core.*``) are imported lazily inside functions
only: ``pcsr.py``/``cost_model.py`` import this package for their own
instrumentation, so a module-level import would be circular.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from time import time as _walltime
from typing import Optional

from repro_torch.obs import metrics as _metrics, trace as _trace

__all__ = [
    "DecisionRecord", "DriftAdvisory", "DRIFT_FEATURES", "DRIFT_THRESHOLD",
    "record_decision", "decision_log", "clear_decisions",
    "graph_snapshot", "check_drift", "resolve_drift_thresholds",
]

_LOCK = threading.Lock()
_LOG: list["DecisionRecord"] = []

#: Snapshot features compared by ``check_drift`` (names match
#: ``repro_torch.core.features.FEATURE_NAMES`` so decider feature dicts are
#: drop-in snapshots).
DRIFT_FEATURES = ("n", "nnz", "d", "d_max", "cv", "rho", "pr_2")

#: Default relative change in a ``DRIFT_FEATURES`` entry that trips an
#: advisory.  Per-feature overrides: pass ``check_drift`` a
#: ``{feature: threshold}`` dict, or set ``REPRO_DRIFT_THRESHOLD`` to a
#: scalar (``"0.1"``) or a comma list (``"nnz=0.1,cv=0.5"``).
DRIFT_THRESHOLD = 0.25

#: Environment hook consulted when ``check_drift`` is called without an
#: explicit threshold.
DRIFT_THRESHOLD_ENV = "REPRO_DRIFT_THRESHOLD"


def resolve_drift_thresholds(threshold=None) -> dict:
    """Normalize a threshold spec into a full ``{feature: float}`` map.

    ``threshold`` may be a scalar (applied to every feature), a partial
    ``{feature: float}`` dict (unlisted features keep ``DRIFT_THRESHOLD``),
    or ``None`` — which consults ``$REPRO_DRIFT_THRESHOLD``: either a
    scalar float string or a comma-separated ``feature=value`` list,
    falling back to ``DRIFT_THRESHOLD`` when unset.  Unknown feature
    names raise (a typo'd override silently never firing is worse than
    an error).
    """
    if threshold is None:
        import os
        spec = os.environ.get(DRIFT_THRESHOLD_ENV, "").strip()
        if not spec:
            threshold = DRIFT_THRESHOLD
        elif "=" in spec:
            threshold = {}
            for item in spec.split(","):
                name, _, val = item.partition("=")
                threshold[name.strip()] = float(val)
        else:
            threshold = float(spec)
    if isinstance(threshold, dict):
        unknown = set(threshold) - set(DRIFT_FEATURES)
        if unknown:
            raise ValueError(f"unknown drift feature(s) {sorted(unknown)} "
                             f"— valid: {DRIFT_FEATURES}")
        return {name: float(threshold.get(name, DRIFT_THRESHOLD))
                for name in DRIFT_FEATURES}
    return {name: float(threshold) for name in DRIFT_FEATURES}


@dataclass
class DecisionRecord:
    """One config pick: who decided, on what input, among which
    candidates, priced by which calibration artifact."""

    source: str                     # "cost_model" | "decider" | "oracle_*"
    op: str
    dim: int
    heads: int
    chosen: tuple                   # ⟨W,F,V,S,B⟩ via SpMMConfig.astuple()
    predicted_seconds: Optional[float]
    topk: list                      # [{"config": [...], "seconds"|"score"}]
    snapshot: dict                  # input features the pick was based on
    calibration: Optional[str]      # artifact id, None = analytic prices
    walltime: float = field(default_factory=_walltime)

    def to_dict(self) -> dict:
        return {
            "source": self.source, "op": self.op, "dim": self.dim,
            "heads": self.heads, "chosen": list(self.chosen),
            "predicted_seconds": self.predicted_seconds,
            "topk": self.topk, "snapshot": self.snapshot,
            "calibration": self.calibration, "walltime": self.walltime,
        }


@dataclass
class DriftAdvisory:
    """``check_drift`` verdict: which snapshot features moved, by how
    much, and the decision they invalidate."""

    drifted: dict                   # feature -> {recorded, current, rel}
    record: DecisionRecord
    message: str


def _cfg_tuple(config) -> tuple:
    """⟨W,F,V,S,B⟩ from an SpMMConfig (or pass tuples through)."""
    astuple = getattr(config, "astuple", None)
    return tuple(astuple()) if astuple is not None else tuple(config)


def _calibration_id(calibration) -> Optional[str]:
    """Stable id for the pricing artifact: fitted ops @ host, or None
    for the hand-set analytic constants."""
    if calibration is None:
        return None
    if isinstance(calibration, (str, bytes)):        # a path to the artifact
        import os
        return os.path.basename(os.fspath(calibration))
    meta = getattr(calibration, "meta", None) or {}
    coef = getattr(calibration, "coef", None) or {}
    ops = "+".join(sorted(coef)) or "uncalibrated"
    return f"{ops}@{meta.get('host', 'unknown-host')}"


def graph_snapshot(csr) -> dict:
    """Cheap ``DRIFT_FEATURES`` snapshot of a CSR matrix — degree stats
    plus the V=2 padding ratio from ``pcsr_stats`` (the layout-facing
    stat re-packing decisions hinge on).  Much cheaper than
    ``extract_features`` (no split/balance searches)."""
    import numpy as np

    from repro_torch.core.pcsr import pcsr_stats

    n, nnz = csr.n_rows, csr.nnz
    deg = csr.degrees.astype(np.float64)
    d = nnz / max(1, n)
    st2 = pcsr_stats(csr.indptr, csr.indices, n, csr.n_cols, 2, 4)
    return {
        "n": float(n), "nnz": float(nnz), "d": d,
        "d_max": float(deg.max()) if n else 0.0,
        "cv": float(deg.std() / d) if d > 0 else 0.0,
        "rho": nnz / max(1, n * csr.n_cols),
        "pr_2": float(st2.padding_ratio),
    }


def record_decision(csr=None, *, source: str, dim: int, chosen,
                    op: str = "spmm", heads: int = 1,
                    predicted_seconds: Optional[float] = None,
                    candidates=None, scores=None, calibration=None,
                    snapshot: Optional[dict] = None,
                    k: int = 5) -> Optional[DecisionRecord]:
    """Append one pick to the decision log (no-op → ``None`` while
    tracing is disabled).  ``candidates`` is an iterable of
    ``(config, seconds)`` pairs — the top-``k`` cheapest are kept;
    ``scores`` is the higher-is-better alternative (the decider's class
    probabilities) kept as the top-``k`` highest.  ``snapshot``
    overrides the ``graph_snapshot(csr)`` default (the decider passes
    its full Table-3 feature dict)."""
    if not _trace.trace_enabled():
        return None
    if snapshot is None:
        snapshot = graph_snapshot(csr) if csr is not None else {}
    topk = []
    if candidates is not None:
        ranked = sorted(((_cfg_tuple(c), float(t)) for c, t in candidates),
                        key=lambda ct: ct[1])[:k]
        topk = [{"config": list(c), "seconds": t} for c, t in ranked]
    elif scores is not None:
        ranked = sorted(((_cfg_tuple(c), float(s)) for c, s in scores),
                        key=lambda cs: -cs[1])[:k]
        topk = [{"config": list(c), "score": s} for c, s in ranked]
    rec = DecisionRecord(
        source=source, op=op, dim=int(dim), heads=int(heads),
        chosen=_cfg_tuple(chosen),
        predicted_seconds=(None if predicted_seconds is None
                           else float(predicted_seconds)),
        topk=topk, snapshot=dict(snapshot),
        calibration=_calibration_id(calibration))
    with _LOCK:
        _LOG.append(rec)
    _metrics.counter("decisions_total").inc(source=source, op=op)
    _trace.instant("decision", cat="decision", source=source, op=op,
                   dim=rec.dim, chosen=list(rec.chosen))
    return rec


def decision_log() -> list[DecisionRecord]:
    """Snapshot of the decision log (survives ``stop_tracing``; cleared
    on the next ``start_tracing`` or by ``clear_decisions``)."""
    with _LOCK:
        return list(_LOG)


def clear_decisions() -> None:
    with _LOCK:
        _LOG.clear()


def check_drift(csr, record: Optional[DecisionRecord] = None, *,
                threshold=None) -> Optional[DriftAdvisory]:
    """Compare ``csr``'s current stats against the feature snapshot a
    decision was made on (default: the most recent logged record).
    Returns a ``DriftAdvisory`` when any ``DRIFT_FEATURES`` entry moved
    by more than its threshold relative — the signal to re-run config
    selection / re-pack — else ``None``.  ``threshold`` accepts a
    scalar, a per-feature dict, or ``None`` (the
    ``$REPRO_DRIFT_THRESHOLD`` env hook / ``DRIFT_THRESHOLD`` default —
    see ``resolve_drift_thresholds``); each drifted entry records the
    threshold that fired it.  Pure comparison: works whether or not
    tracing is currently enabled (the advisory counter/event only fire
    when it is)."""
    if record is None:
        log = decision_log()
        if not log:
            raise ValueError("no decision recorded — nothing to check "
                             "drift against")
        record = log[-1]
    thresholds = resolve_drift_thresholds(threshold)
    current = graph_snapshot(csr)
    drifted = {}
    for name in DRIFT_FEATURES:
        if name not in record.snapshot:
            continue
        old, new = float(record.snapshot[name]), float(current[name])
        rel = abs(new - old) / max(abs(old), 1e-12)
        if rel > thresholds[name]:
            drifted[name] = {"recorded": old, "current": new, "rel": rel,
                             "threshold": thresholds[name]}
    if not drifted:
        return None
    moved = ", ".join(f"{k} {v['recorded']:.3g}→{v['current']:.3g} "
                      f"({v['rel']:+.0%} > {v['threshold']:.0%})"
                      for k, v in drifted.items())
    msg = (f"input drifted since the {record.source} pick of "
           f"{record.chosen} (op={record.op}, dim={record.dim}): {moved} "
           f"— re-run config selection / re-pack")
    _metrics.counter("drift_advisories_total").inc(source=record.source)
    _trace.instant("drift_advisory", cat="decision",
                   features=sorted(drifted), source=record.source)
    return DriftAdvisory(drifted=drifted, record=record, message=msg)
