"""The program's spans inside ``train_gnn`` (``repro_torch.obs``), on the
CPU.

* ``gnn.pack`` holds ``pack.reorder``, ``pack.pick`` and ``pack.pcsr``;
  ``pack.pcsr`` holds the two ``pcsr.build`` of A and Aᵀ; ``pack.pick``
  is absent when a config is given.
* Every step span holds one ``gnn.forward``, ``gnn.backward``,
  ``gnn.optimizer`` and ``gnn.sync``, in that order; GAT's
  ``gat.transpose_side`` is built once, inside ``gnn.first_step``.
* Tracing leaves the losses bit-equal.
* While a session is on, a span is a ``torch.profiler`` user annotation
  of its name; off, ``span()`` is the shared null span and enters no
  ``record_function``.
* The pack leaves no ``pack_build_seconds`` or ``pack_cache_*`` series.
"""
import pytest
import torch

from repro_torch import obs
from repro_torch.apps.gnn import train_gnn
from repro_torch.data.tasks import community_task
from repro_torch.obs import trace
from repro_torch.pipeline import ParamSpMM

TASK = dict(n_blocks=4, block_size=24, feat_dim=8, p_in=0.3, seed=5)
STEPS = 3
PHASES = ["gnn.forward", "gnn.backward", "gnn.optimizer", "gnn.sync"]


def _train(model):
    return train_gnn(community_task(**TASK), model=model, hidden=16,
                     n_layers=2, steps=STEPS, heads=2 if model == "gat"
                     else 1, device="cpu")


@pytest.fixture(scope="module", params=["gcn", "gat"])
def traced(request):
    with obs.tracing():
        res = _train(request.param)
        events = [e for e in obs.trace_events() if e["ph"] == "X"]
        snap = obs.metrics_snapshot()
    return request.param, res, events, snap


def _named(events, name):
    return [e for e in events if e["name"] == name]


def _holds(outer, inner):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _held(events, name, outer):
    return [e for e in _named(events, name) if _holds(outer, e)]


def test_pack_holds_reorder_pick_and_pcsr(traced):
    _, _, events, _ = traced
    (pack,) = _named(events, "gnn.pack")
    for name in ("pack.reorder", "pack.pick", "pack.pcsr"):
        assert len(_held(events, name, pack)) == 1, name
    (pcsr,) = _named(events, "pack.pcsr")
    assert len(_held(events, "pcsr.build", pcsr)) == 2
    order = sorted(_named(events, n)[0]["ts"] for n in
                   ("pack.reorder", "pack.pick", "pack.pcsr"))
    assert order == [_named(events, n)[0]["ts"] for n in
                     ("pack.reorder", "pack.pick", "pack.pcsr")]


def test_every_step_holds_its_four_phases_in_order(traced):
    _, _, events, _ = traced
    steps = _named(events, "gnn.first_step") + _named(events, "gnn.step")
    assert sorted(e["args"]["step"] for e in steps) == list(range(STEPS))
    for st in steps:
        held = [e for n in PHASES for e in _held(events, n, st)]
        assert [e["name"] for e in sorted(held, key=lambda e: e["ts"])] \
            == PHASES, st["args"]
        assert {e["args"]["step"] for e in held} == {st["args"]["step"]}
        for a, b in zip(sorted(held, key=lambda e: e["ts"]),
                        sorted(held, key=lambda e: e["ts"])[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]


def test_gat_transpose_side_once_in_step_0(traced):
    model, _, events, _ = traced
    sides = _named(events, "gat.transpose_side")
    if model != "gat":
        assert sides == []
        return
    (first,) = _named(events, "gnn.first_step")
    assert len(sides) == 1 and _holds(first, sides[0])
    (backward,) = [e for e in _named(events, "gnn.backward")
                   if e["args"]["step"] == 0]
    assert _holds(backward, sides[0])


def test_losses_bit_equal_with_tracing_off(traced):
    model, res, _, _ = traced
    assert not obs.trace_enabled()
    assert _train(model).losses == res.losses


def test_pack_leaves_no_pack_build_or_cache_series(traced):
    _, _, _, snap = traced
    assert not [k for k in snap
                if k == "pack_build_seconds" or k.startswith("pack_cache_")]


def test_pick_span_absent_when_a_config_is_given():
    task = community_task(**TASK)
    picked = ParamSpMM(task.csr, 16, device="cpu")
    with obs.tracing():
        ParamSpMM(task.csr, 16, config=picked.config, device="cpu")
        names = [e["name"] for e in obs.trace_events()]
    assert "pack.pick" not in names
    assert names.count("pack.reorder") == names.count("pack.pcsr") == 1


def _annotations(tracing_on: bool):
    from torch.profiler import ProfilerActivity, profile
    if tracing_on:
        obs.start_tracing()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("x"):
                torch.ones(3).add_(1)
    finally:
        if tracing_on:
            obs.stop_tracing()
    return [(e.name, e.is_user_annotation) for e in prof.events()
            if e.name == "x"]


@pytest.mark.parametrize("tracing_on", [True, False], ids=["on", "off"])
def test_span_is_a_user_annotation_only_while_tracing(tracing_on):
    got = _annotations(tracing_on)
    assert got == ([("x", True)] if tracing_on else [])


def test_span_off_is_the_null_span_and_enters_no_record_function(
        monkeypatch):
    entered = []

    class Probe:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(trace, "record_function", Probe)
    assert not obs.trace_enabled()
    s = obs.span("off")
    assert s is trace._NULL_SPAN
    with s:
        pass
    assert entered == []
    with obs.tracing():
        with obs.span("on"):
            pass
    assert entered == ["on"]
