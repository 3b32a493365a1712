"""Readings of the program's spans (``repro_torch.obs``) for the
per-layer metrics: the seconds of spans held by another, and the device's
idle time by the program range the host was in.  Each returns ``None``
where the program has no such span."""
from __future__ import annotations

from perfbench import devtrace


def complete(spans, name):
    """The complete ("X") events named ``name``."""
    return [e for e in spans if e.get("ph") == "X" and e.get("name") == name]


def _holds(outer, inner) -> bool:
    # ts and dur are float µs of one clock: a child's end may round a few
    # ulps past its parent's
    return (outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
            <= outer["ts"] + outer["dur"] + 1e-3)


def held_s(spans, name, parent):
    """Seconds of the ``name`` spans that a ``parent`` span holds, summed."""
    outer = complete(spans, parent)
    durs = [e["dur"] for e in complete(spans, name)
            if any(_holds(p, e) for p in outer)]
    return sum(durs) * 1e-6 if durs else None


def idle_in_ms(labels, phase):
    """Device-idle ms a step of the labelled window (``devtrace.
    DeviceWindow`` with the host) whose gaps' middles fall in a host range
    named ``phase``: each gap between merged device ops counts whole
    toward the range that holds its middle (ranges half-open, so a
    middle where one phase ends and the next starts counts once)."""
    if labels is None or not labels.ops:
        return None
    ranges = [(s, s + d) for n, s, d in labels.host if n == phase]
    if not ranges:
        return None
    merged = devtrace._union((s, s + d) for _, s, d in labels.ops)
    idle = sum(s1 - e0 for (_, e0), (s1, _) in zip(merged, merged[1:])
               if any(a <= 0.5 * (e0 + s1) < b for a, b in ranges))
    return idle / labels.steps * 1e3
