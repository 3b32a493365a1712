"""Labeled counter/gauge/histogram registry for the obs layer.

Instruments are cheap named handles — ``counter("serve_cache_hits_total")``
returns the same object every call — and every mutating method
(``inc``/``set``/``observe``) is a no-op unless a tracing session is active, so
instrumented hot paths cost a dict lookup and a boolean check when the
layer is off.  Label sets distinguish series within one instrument;
``metrics_snapshot()`` renders everything into plain JSON-ready dicts
keyed ``"k=v,k2=v2"``.
"""
from __future__ import annotations

import threading

from repro_torch.obs import trace as _trace

__all__ = ["counter", "gauge", "histogram", "metrics_snapshot",
           "reset_metrics"]

_LOCK = threading.Lock()
_REGISTRY: dict[str, "_Instrument"] = {}


def _label_key(labels: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


class _Instrument:
    kind = "?"

    def __init__(self, name: str):
        self.name = name
        self._series: dict[str, object] = {}


class Counter(_Instrument):
    """Monotonically increasing per-label-set totals."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if not _trace.trace_enabled():
            return
        key = _label_key(labels)
        with _LOCK:
            self._series[key] = self._series.get(key, 0.0) + value


class Gauge(_Instrument):
    """Last-write-wins per-label-set values."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not _trace.trace_enabled():
            return
        with _LOCK:
            self._series[_label_key(labels)] = float(value)


class Histogram(_Instrument):
    """Streaming count/sum/min/max per label set."""

    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        if not _trace.trace_enabled():
            return
        value = float(value)
        key = _label_key(labels)
        with _LOCK:
            st = self._series.get(key)
            if st is None:
                self._series[key] = {"count": 1, "sum": value,
                                     "min": value, "max": value}
            else:
                st["count"] += 1
                st["sum"] += value
                st["min"] = min(st["min"], value)
                st["max"] = max(st["max"], value)


def _get(name: str, cls) -> _Instrument:
    with _LOCK:
        inst = _REGISTRY.get(name)
        if inst is None:
            inst = _REGISTRY[name] = cls(name)
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{inst.kind}, not {cls.kind}")
        return inst


def counter(name: str) -> Counter:
    """Get-or-create the named counter."""
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    """Get-or-create the named gauge."""
    return _get(name, Gauge)


def histogram(name: str) -> Histogram:
    """Get-or-create the named histogram."""
    return _get(name, Histogram)


def metrics_snapshot() -> dict:
    """``{metric_name: {"k=v,...": value_or_stats}}`` for every series
    with at least one observation (JSON-ready)."""
    with _LOCK:
        return {name: {k: (dict(v) if isinstance(v, dict) else v)
                       for k, v in inst._series.items()}
                for name, inst in _REGISTRY.items() if inst._series}


def reset_metrics() -> None:
    """Zero every series (instruments stay registered)."""
    with _LOCK:
        for inst in _REGISTRY.values():
            inst._series = {}
