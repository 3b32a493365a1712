"""Process-wide telemetry: spans, counters, decision log, drift checks.

Tracing is off by default and every instrumentation point in the hot
paths degrades to a near-zero no-op.  Enable with ``obs.tracing(path)``,
the ``--trace`` flag of ``repro_torch.apps.serve_gnn``, or for a whole
process with ``REPRO_TRACE=trace.json`` (written at exit).  While it is
on, every span is also a ``torch.profiler.record_function`` range, so a
``torch.profiler`` that records CPU activity shows the spans beside the
host and device ops, on their clock.
"""
from repro_torch.obs.trace import (
    tracing, start_tracing, stop_tracing, trace_enabled, span, instant,
    export_trace, trace_events, _env_autostart,
)
from repro_torch.obs.metrics import (
    counter, gauge, histogram, metrics_snapshot, reset_metrics,
)
from repro_torch.obs.decisions import (
    DecisionRecord, DriftAdvisory, DRIFT_FEATURES, DRIFT_THRESHOLD,
    record_decision, decision_log, clear_decisions,
    graph_snapshot, check_drift, resolve_drift_thresholds,
)

__all__ = [
    "tracing", "start_tracing", "stop_tracing", "trace_enabled", "span",
    "instant", "export_trace", "trace_events",
    "counter", "gauge", "histogram", "metrics_snapshot", "reset_metrics",
    "DecisionRecord", "DriftAdvisory", "DRIFT_FEATURES", "DRIFT_THRESHOLD",
    "record_decision", "decision_log", "clear_decisions",
    "graph_snapshot", "check_drift", "resolve_drift_thresholds",
]

_env_autostart()
del _env_autostart
