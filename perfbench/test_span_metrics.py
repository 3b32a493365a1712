"""CPU tests of the per-layer metrics that read the program's spans
(``spans.py`` and its readers in ``metrics/``), on hand-made contexts:
run them from the checkout's root, ``python -m pytest -q
perfbench/test_span_metrics.py``."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import bench, devtrace  # noqa: E402


def _read(name, **ctx):
    return bench.load_module("metrics", name).read(SimpleNamespace(**ctx))


def _x(name, ts, dur, **args):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "args": args}


PACK = [_x("gnn.pack", 0.0, 10e6),
        _x("pack.reorder", 1e6, 2e6), _x("pack.pick", 3e6, 0.5e6),
        _x("pack.pcsr", 4e6, 5e6), _x("pcsr.build", 4e6, 2e6),
        # a pcsr.build and a reorder outside any pack are not read
        _x("pack.reorder", 20e6, 7e6), _x("pcsr.build", 30e6, 1e6)]


@pytest.mark.parametrize("name, span, want", [
    ("reorder_s", "pack.reorder", 2.0), ("pick_s", "pack.pick", 0.5),
    ("pcsr_s", "pack.pcsr", 5.0)])
def test_pack_readers_sum_the_spans_inside_the_pack(name, span, want):
    spans = PACK + [_x("gnn.pack", 40e6, 3e6), _x(span, 41e6, 1e6)]
    assert _read(name, spans=spans) == pytest.approx(want + 1.0)
    assert _read(name, spans=[_x("gnn.pack", 0.0, 1e6)]) is None


def test_transpose_side_sums_its_spans():
    spans = [_x("gnn.first_step", 0.0, 5e6, step=0),
             _x("gat.transpose_side", 1e6, 1.5e6)]
    assert _read("transpose_side_s", spans=spans) == pytest.approx(1.5)
    assert _read("transpose_side_s", spans=PACK) is None


def test_step_host_ms_reads_only_the_steps_before_cupti():
    """Steps 1–3 before CUPTI (host 2, 4 and 3 ms); step 4's 50 ms and
    step 0 are not read."""
    spans, t = [], 0.0
    for k, (step_us, sync_us) in enumerate([(90e3, 1e3), (7e3, 5e3),
                                            (9e3, 5e3), (8e3, 5e3),
                                            (60e3, 10e3)]):
        spans += [_x("gnn.first_step" if k == 0 else "gnn.step", t, step_us,
                     step=k),
                  _x("gnn.sync", t + step_us - sync_us, sync_us, step=k)]
        t += step_us + 100.0
    assert _read("step_host_ms", spans=spans,
                 steps_s=[0.007, 0.009, 0.008]) == pytest.approx(3.0)
    parent = [e for e in spans if e["name"] != "gnn.sync"]
    assert _read("step_host_ms", spans=parent, steps_s=[0.007]) is None


def _labels():
    """Two steps (ms): device ops at 0–1, 2–3, 5–6, 6.5–7 and 10–11; the
    host in forward 0–2.5, backward 2.5–4 and 8–9.5, optimizer 4–5.
    Gaps: 1–2 (middle 1.5: forward), 3–5 (4.0, where backward ends and
    optimizer starts: optimizer), 6–6.5 (6.25: no phase) and 7–10 (8.5:
    backward)."""
    ms = 1e-3
    ops = [(f"k{i}", a * ms, (b - a) * ms) for i, (a, b) in
           enumerate([(0, 1), (2, 3), (5, 6), (6.5, 7), (10, 11)])]
    host = [("gnn.forward", 0.0, 2.5 * ms),
            ("gnn.backward", 2.5 * ms, 1.5 * ms),
            ("gnn.optimizer", 4 * ms, 1 * ms),
            ("gnn.backward", 8 * ms, 1.5 * ms),
            ("aten::mul", 1.4 * ms, 0.2 * ms)]
    return devtrace.DeviceWindow(2, ops, host)


@pytest.mark.parametrize("name, want", [("forward_idle_ms", 0.5),
                                        ("backward_idle_ms", 1.5),
                                        ("optimizer_idle_ms", 1.0)])
def test_idle_gaps_go_to_the_phase_at_their_middle(name, want):
    labels = _labels()
    assert _read(name, labels=labels) == pytest.approx(want)
    assert _read(name, labels=None) is None
    bare = devtrace.DeviceWindow(2, labels.ops, [("aten::mul", 0.0, 1.0)])
    assert _read(name, labels=bare) is None


def test_phase_idle_sums_to_no_more_than_the_window_idle():
    labels = _labels()
    merged = devtrace._union((s, s + d) for _, s, d in labels.ops)
    idle_ms = sum(b[0] - a[1] for a, b in zip(merged, merged[1:])) \
        / labels.steps * 1e3
    phases = sum(_read(f"{p}_idle_ms", labels=labels)
                 for p in ("forward", "backward", "optimizer"))
    # the 0.5 ms gap outside every phase is left out
    assert phases == pytest.approx(idle_ms - 0.25)
