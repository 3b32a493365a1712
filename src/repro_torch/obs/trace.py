"""Nestable spans and instant events with Chrome-trace-event JSON export.

One process-wide switch gates the whole ``repro_torch.obs`` layer:
tracing is off by default and every instrumentation point degrades to a
handful of attribute loads (``span`` returns a shared null context
manager, counters return immediately).  Enable it with the
``tracing(path)`` context manager or ``start_tracing()``/``stop_tracing()``.

Exported files follow the Chrome trace event format: ``"X"`` complete
events (``ts``/``dur`` in microseconds) nest by containment per thread,
``"i"`` instant events mark points in time, and one ``"C"`` counter
event per metric series is appended at export.  The top-level keys
``repro_metrics`` and ``repro_decisions`` carry the full metric snapshot
and the config-pick decision log (``repro_torch.obs.decisions``).

While a session is on, each span is also a ``torch.profiler.
record_function`` range over the same interval, so any ``torch.profiler``
that records CPU activity holds every span as a ``user_annotation`` event
on the clock of its host and device ops.  The exported file keeps the
spans on this module's own clock (``perf_counter``).

Kernel launches are not traced here: each kernel wrapper keeps its own
launch count (``repro_torch.kernels.paramspmm.ops.launch_count``).
"""
from __future__ import annotations

import json
import os
import threading
from time import perf_counter
from typing import Any, Optional

from torch.autograd.profiler import record_function

__all__ = ["tracing", "start_tracing", "stop_tracing", "trace_enabled",
           "span", "instant", "export_trace", "trace_events"]

_LOCK = threading.Lock()
_STATE: Optional["_TraceState"] = None


class _TraceState:
    __slots__ = ("events", "t0", "path")

    def __init__(self, path=None):
        self.events: list[dict] = []
        self.t0 = perf_counter()
        self.path = path

    def now_us(self) -> float:
        return (perf_counter() - self.t0) * 1e6

    def add(self, event: dict) -> None:
        with _LOCK:
            self.events.append(event)


def trace_enabled() -> bool:
    """True while a tracing session is active."""
    return _STATE is not None


class _Span:
    """Context manager emitting one ``"X"`` complete event on exit, inside
    a ``record_function`` range of the same name."""

    __slots__ = ("_state", "_name", "_cat", "_args", "_ts", "_rf")

    def __init__(self, state, name, cat, args):
        self._state, self._name, self._cat, self._args = \
            state, name, cat, args

    def __enter__(self):
        self._rf = record_function(self._name)
        self._rf.__enter__()
        self._ts = self._state.now_us()
        return self

    def __exit__(self, *exc):
        st = self._state
        dur = st.now_us() - self._ts
        self._rf.__exit__(*exc)
        st.add({"name": self._name, "cat": self._cat, "ph": "X",
                "ts": self._ts, "dur": dur,
                "pid": os.getpid(), "tid": threading.get_ident(),
                "args": self._args})
        return False


class _NullSpan:
    """Shared no-op span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, cat: str = "repro", **args: Any):
    """Open a nestable span: ``with span("serve.batch", bucket=k): ...``.
    Returns a shared null context manager when tracing is disabled (no
    ``record_function`` then)."""
    st = _STATE
    if st is None:
        return _NULL_SPAN
    return _Span(st, name, cat, args)


def instant(name: str, cat: str = "repro", **args: Any) -> None:
    """Record a point-in-time ``"i"`` event (no-op when disabled)."""
    st = _STATE
    if st is None:
        return
    st.add({"name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": st.now_us(), "pid": os.getpid(),
            "tid": threading.get_ident(), "args": args})


def trace_events() -> list[dict]:
    """Snapshot of the event buffer (empty list when disabled)."""
    st = _STATE
    if st is None:
        return []
    with _LOCK:
        return list(st.events)


def start_tracing(path: Optional[str] = None) -> None:
    """Open a tracing session with a fresh event buffer, a zeroed
    metrics registry and an empty decision log (a trace captures its own
    window).  Raises if a session is already active."""
    global _STATE
    if _STATE is not None:
        raise RuntimeError("tracing already active")
    from repro_torch.obs import decisions as _decisions, metrics as _metrics
    _STATE = _TraceState(path)
    _metrics.reset_metrics()
    _decisions.clear_decisions()


def export_trace(path: str) -> str:
    """Write the current buffer + metric snapshot + decision log as
    Chrome-trace JSON without stopping the session.  Returns ``path``."""
    from repro_torch.obs import decisions as _decisions, metrics as _metrics
    st = _STATE
    events = trace_events()
    end_us = st.now_us() if st is not None else 0.0
    snapshot = _metrics.metrics_snapshot()
    for mname, series in sorted(snapshot.items()):
        for labels, value in sorted(series.items()):
            if isinstance(value, dict):          # histogram stats
                value = value.get("sum", 0.0)
            disp = f"{mname}{{{labels}}}" if labels else mname
            events.append({"name": disp, "ph": "C", "ts": end_us,
                           "pid": os.getpid(), "tid": 0,
                           "args": {"value": value}})
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "repro_metrics": snapshot,
                   "repro_decisions": [r.to_dict() for r in
                                       _decisions.decision_log()]},
                  fh, indent=1, default=str)
    return path


def stop_tracing(path: Optional[str] = None) -> Optional[str]:
    """End the session; write the trace to ``path`` (or the path given
    at start) if any.  The decision log survives the stop, so
    ``check_drift`` can run against it later.  Returns the written path."""
    global _STATE
    st = _STATE
    if st is None:
        return None
    out = path or st.path
    written = export_trace(out) if out else None
    _STATE = None
    return written


class _Tracing:
    """``with tracing(path):`` — start on enter, write + stop on exit."""

    def __init__(self, path=None):
        self._path = path

    def __enter__(self):
        start_tracing(self._path)
        return self

    def __exit__(self, *exc):
        stop_tracing()
        return False


def tracing(path: Optional[str] = None) -> _Tracing:
    """Context manager enabling the obs layer for its body; exports the
    Chrome-trace JSON to ``path`` on exit when one is given."""
    return _Tracing(path)


def _env_autostart() -> None:
    """``REPRO_TRACE=trace.json`` starts a process-lifetime session whose
    trace is written at interpreter exit (called once from
    ``repro_torch.obs.__init__``)."""
    path = os.environ.get("REPRO_TRACE")
    if not path or _STATE is not None:
        return
    import atexit
    start_tracing(path)
    atexit.register(stop_tracing)
