"""PyTorch port vs JAX reference: the oracle config search.

Model mode prices with the cost model in both packages, so with the
reference's constants (``REF_HW``) and the same calibration the port's
times and best config are *equal* to the reference's.  Measured mode
times the port's kernels on the card; on ``device="cpu"`` it times their
plain versions (which launch nothing), and with no device named and no
card it raises.  Its numbers are host times here, so only their shape is
checked: one finite positive time per config, the best the argmin.
"""
import functools
import pathlib

import numpy as np
import pytest
import torch

from repro.core import autotune as rat
from repro.core import calibrate as rc
from repro.data.graphs import corpus as ref_corpus

from repro_torch import obs
from repro_torch.core import autotune as tat
from repro_torch.core import calibrate as tc
from repro_torch.core.cost_model import CostModel
from repro_torch.core.pcsr import config_space
from repro_torch.data.graphs import corpus, er
from repro_torch.kernels.paramspmm import ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.pipeline import pick_config

from test_torch_pcsr import REF_HW

CPU_ARTIFACT = (pathlib.Path(__file__).resolve().parents[1] / "configs"
                / "calibration_cpu_host.json")


@functools.lru_cache(maxsize=None)
def _graphs(name):
    return (next(g.csr for g in ref_corpus("small") if g.name == name),
            next(g.csr for g in corpus("small") if g.name == name))


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("op", ["spmm", "sddmm", "gat"])
def test_model_mode_equals_reference(op, H, calibrated):
    cal_r = rc.CalibrationResult.load(CPU_ARTIFACT) if calibrated else None
    cal_t = (tc.CalibrationResult.load(CPU_ARTIFACT) if calibrated
             else None)
    for name in ("rmat10", "sbm8x64"):
        rcsr, tcsr = _graphs(name)
        for dim in (16, 64, 200):
            r = rat.oracle_search(rcsr, dim, mode="model", op=op, H=H,
                                  calibration=cal_r)
            t = tat.oracle_search(tcsr, dim, mode="model", op=op, H=H,
                                  cm=CostModel(tcsr, REF_HW,
                                               calibration=cal_t))
            assert {c.astuple(): v for c, v in t.times.items()} == \
                {c.astuple(): v for c, v in r.times.items()}
            assert t.best_config.astuple() == r.best_config.astuple()
            assert t.best_time == r.best_time



@pytest.mark.parametrize("op", ["spmm", "sddmm", "gat"])
def test_model_mode_loads_a_calibration_path(op):
    _, tcsr = _graphs("rmat10")
    by_path = tat.oracle_search(tcsr, 64, mode="model", op=op,
                                calibration=str(CPU_ARTIFACT))
    cm = CostModel.from_calibration(tcsr, CPU_ARTIFACT)
    assert by_path.times == tat.oracle_search(tcsr, 64, mode="model",
                                              op=op, cm=cm).times

@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("op", ["spmm", "sddmm", "gat"])
def test_measured_mode_on_cpu_times_the_plain_versions(op, H):
    g = er(48, 4, seed=3)
    space = config_space(64)
    before = (ops.launch_count(), sddmm_ops.launch_count("sddmm"),
              sddmm_ops.launch_count("sddmm_softmax"))
    res = tat.oracle_search(g, 64, mode="measured", reps=1, op=op, H=H,
                            device="cpu")
    assert (ops.launch_count(), sddmm_ops.launch_count("sddmm"),
            sddmm_ops.launch_count("sddmm_softmax")) == before
    assert list(res.times) == space
    t = np.array(list(res.times.values()))
    assert np.isfinite(t).all() and (t > 0).all()
    assert res.best_config == min(res.times, key=res.times.get)
    assert res.best_time == t.min()


def test_measured_mode_reuses_packs():
    g = er(40, 3, seed=4)
    packs = {}
    space = config_space(32)[:4]
    tat.oracle_search(g, 32, space=space, mode="measured", reps=1,
                      device="cpu", packs=packs)
    assert list(packs) == space
    first = dict(packs)
    tat.oracle_search(g, 32, space=space, mode="measured", reps=1,
                      op="sddmm", device="cpu", packs=packs)
    assert all(packs[c] is first[c] for c in space)


def test_measured_mode_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = er(30, 3, seed=5)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tat.oracle_search(g, 32, mode="measured", reps=1, device=dev)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pick_config(g, 32, select="measured", device=dev)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tat.time_fn(lambda: None, device=dev)
    # model mode needs no device
    assert tat.oracle_search(g, 32, mode="model").best_config in \
        config_space(32)


def test_time_fn_counts_measurements_and_calls():
    calls = []
    with obs.tracing():
        t = tat.time_fn(lambda x: calls.append(x), 7, reps=4, warmup=2,
                        device="cpu")
        snap = obs.metrics_snapshot()
    assert calls == [7] * 6 and t >= 0
    assert sum(snap["autotune_measurements_total"].values()) == 4


def test_pick_config_measured_on_cpu():
    g = er(40, 4, seed=6)
    for op, heads in (("spmm", 1), ("gat", 4)):
        cfg = pick_config(g, 64, select="measured", op=op, heads=heads,
                          device="cpu")
        assert cfg in config_space(64)
    with pytest.raises(ValueError, match="select"):
        pick_config(g, 64, select="bogus")


def test_oracle_records_its_decision():
    rcsr, tcsr = _graphs("ba1k")
    with obs.tracing():
        res = tat.oracle_search(tcsr, 64, mode="model", op="gat", H=4)
        log = obs.decision_log()
    assert len(log) == 1          # the oracle prices with `time`, so the
    rec = log[0]                  # cost model records no pick of its own
    assert rec.source == "oracle_model" and rec.op == "gat"
    assert rec.heads == 4 and rec.chosen == res.best_config.astuple()
    assert rec.topk[0]["seconds"] == res.best_time


def test_throughput_equals_reference():
    rcsr, tcsr = _graphs("er1k")
    assert tat.throughput_gflops(tcsr, 64, 1e-3) == \
        rat.throughput_gflops(rcsr, 64, 1e-3)
