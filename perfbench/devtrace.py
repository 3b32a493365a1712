"""Reduction of a ``torch.profiler`` Chrome trace to what the metrics
read: device ops with their times, busy time, the window, the largest ops
and the idle gaps labelled by the host op that ran meanwhile."""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


def chrome_events(prof) -> list[dict]:
    """The complete ("X") events of a stopped profiler, through its
    Chrome-trace export (a temporary file, removed at once)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    """Sorted, merged ``[start, end]`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclass
class DeviceWindow:
    """Device ops of ``steps`` profiled steps (times in seconds)."""
    steps: int
    ops: list = field(default_factory=list)      # (name, start_s, dur_s)
    host: list = field(default_factory=list)     # (name, start_s, dur_s)

    @classmethod
    def from_events(cls, events, steps):
        dev, host = [], []
        for e in events:
            cat = str(e.get("cat", "")).lower()
            row = (e.get("name", "?"), float(e["ts"]) * 1e-6,
                   float(e["dur"]) * 1e-6)
            if cat in DEVICE_CATS:
                dev.append(row)
            elif cat in HOST_CATS:
                host.append(row)
        return cls(steps, sorted(dev, key=lambda r: r[1]), host)

    @property
    def busy_s(self) -> float:
        """Seconds in which a device op ran."""
        return sum(e - s for s, e in _union(
            (s, s + d) for _, s, d in self.ops))

    @property
    def window_s(self) -> float:
        """From the first device op's start to the last one's end: the
        host gap before the first profiled step's first op and after the
        last one's last op are left out."""
        if not self.ops:
            return 0.0
        return (max(s + d for _, s, d in self.ops)
                - min(s for _, s, _ in self.ops))

    def seconds_by(self, key) -> dict:
        out: dict = {}
        for name, _, d in self.ops:
            k = key(name)
            out[k] = out.get(k, 0.0) + d
        return out

    def top_ops(self, k=10):
        return sorted(([n[:120], s] for n, s in
                       self.seconds_by(lambda n: n).items()),
                      key=lambda r: -r[1])[:k]

    def idle_gaps(self, k=10):
        """Idle device time summed by the innermost host op running at
        each gap's middle, the ``k`` largest."""
        merged = _union((s, s + d) for _, s, d in self.ops)
        out: dict = {}
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            mid = 0.5 * (e0 + s1)
            inner = [(d, n) for n, s, d in self.host if s <= mid <= s + d]
            label = min(inner)[1][:120] if inner else "(no host op)"
            out[label] = out.get(label, 0.0) + (s1 - e0)
        return sorted(([n, s] for n, s in out.items()),
                      key=lambda r: -r[1])[:k]
