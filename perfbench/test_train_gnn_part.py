"""CPU tests of the partitioned training driver (``drivers/
train_gnn_part.py``, cell ``gcn.train.part4``): the cell's four ranks run
here over gloo on the CPU on a small graph, as processes the driver
starts; run them from the checkout's root:
``python -m pytest -q perfbench/test_train_gnn_part.py``."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import bench  # noqa: E402

CELL = "gcn.train.part4"
# The partitioned cell's readers (``metrics/part4_*.py``), which the tiny
# cell declares: ``BENCHMARK.json`` does not declare ``gcn.train.part4``.
PART4_METRICS = [
    ("part4_collective_ms", "ms", "device_trace"),
    ("part4_step_p95_ms", "ms", "host_clock"),
    ("part4_spmm_roofline", "%", "device_trace"),
    ("part4_device_idle", "%", "device_trace"),
    ("part4_other_device_ms", "ms", "device_trace"),
    ("part4_forward_idle_ms", "ms", "device_trace"),
    ("part4_backward_idle_ms", "ms", "device_trace"),
    ("part4_optimizer_idle_ms", "ms", "device_trace"),
    ("part4_pack_s", "s", "program_span")]


def _tiny_tree(tmp: Path, limits=None) -> Path:
    """A copy of the benchmark with a cell of the part4 traffic on a
    512-node R-MAT graph (``cells/gcn.train.part4.json``'s limits unless
    given) and the part4 readers."""
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    (tmp / "perfbench" / "cache").mkdir()
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((ROOT / "perfbench/traffic/part4.json").read_text())
    traffic["graph"] = {"n_log2": 9, "avg_deg": 8}
    traffic["graph_seed"] = 3
    (tmp / "perfbench/traffic/tinypart.json").write_text(json.dumps(traffic))
    real = json.loads((ROOT / f"perfbench/cells/{CELL}.json").read_text())
    name = "gcn.train.tinypart"
    b["workloads"].append({"name": name, "config": "gcn",
                           "traffic": "tinypart", "chips": 4,
                           "why": "a tiny CPU cell"})
    for metric, unit, source in PART4_METRICS:
        b["per_layer"].append({"name": metric, "unit": unit,
                               "better": "lower", "source": source,
                               "layer": "partitioned training",
                               "moves": "step_ms", "workloads": [name]})
    (tmp / f"perfbench/cells/{name}.json").write_text(json.dumps(
        {"nominal_step_ms": 1, "limits": limits or real["limits"]}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp / "perfbench"


def _run(root, trace=False, seed=2 ** 31 + 5):
    cell = bench.load_cell("gcn.train.tinypart", root)
    drv = bench.load_module("drivers", cell.traffic["driver"], root)
    return drv.run(cell, seed, 0.004, trace, time.perf_counter(),
                   device="cpu")


def test_four_gloo_ranks_on_the_cpu_follow_the_reference(tmp_path):
    res, checks = _run(_tiny_tree(tmp_path))
    assert res["correct"], checks
    assert res["attempted"] == 4 and res["failed"] == 0
    assert set(res["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    assert res["metrics"]["setup_s"]["value"] > 0
    assert checks["loss_gap"]["value"] < 1e-6


def test_a_traced_run_reads_the_collectives(tmp_path):
    """On the CPU a traced run reads rank 0's pack span and no device
    metric; the collectives' reader takes NCCL's kernels by name."""
    from perfbench import devtrace
    res, checks = _run(_tiny_tree(tmp_path), trace=True)
    assert res["correct"], checks
    assert set(res["metrics"]) == {"part4_pack_s"}
    assert res["metrics"]["part4_pack_s"]["value"] > 0
    reader = bench.load_module("metrics", "part4_collective_ms")
    prof = devtrace.DeviceWindow(2, [
        ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
         0.0, 0.003),
        ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
         0.01, 0.001),
        ("void paramspmm_kernel<1, 4, true>(int const*)", 0.02, 0.005)])
    assert reader.read(SimpleNamespace(prof=prof)) == pytest.approx(2.0)
    assert reader.read(SimpleNamespace(prof=None)) is None


# Faults that only a partitioned run can have, planted in every rank.
PLANTS = {
    "all_reduce_left_out": """
from repro_torch.dist import comm
comm.Comm.all_reduce_sum = lambda self, x: x
""",
    "halo_left_out": """
import torch
from repro_torch.dist import halo
_finish = halo.HaloPlan.finish
halo.HaloPlan.finish = lambda self, full: torch.zeros_like(
    _finish(self, full))
""",
}


@pytest.mark.parametrize("fault", sorted(PLANTS))
def test_a_partition_fault_reads_not_correct(tmp_path, fault):
    plant = tmp_path / "plant.py"
    plant.write_text(PLANTS[fault])
    root = _tiny_tree(tmp_path)
    cell = bench.load_cell("gcn.train.tinypart", root)
    drv = bench.load_module("drivers", cell.traffic["driver"], root)
    res, checks = drv.run(cell, 2 ** 31 + 5, 0.004, False,
                          time.perf_counter(), device="cpu", plant=plant)
    assert not res["correct"], checks


def test_limits_that_nothing_passes_read_not_correct(tmp_path):
    root = _tiny_tree(tmp_path, {"loss_gap": -1.0, "grad_gap": 1.0,
                                 "change_gap": 1.0})
    res, checks = _run(root)
    assert not res["correct"] and checks["loss_gap"]["value"] >= 0


def test_a_failing_rank_ends_the_run_and_raises(tmp_path, monkeypatch):
    """A rank that exits non-zero (here: a workload no rank can load)
    ends the run at once with an error, not a hang."""
    root = _tiny_tree(tmp_path)
    cell = bench.load_cell("gcn.train.tinypart", root)
    drv = bench.load_module("drivers", cell.traffic["driver"], root)
    bad = SimpleNamespace(**{**vars(cell), "name": "no.such.cell"})
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="failed"):
        drv.run(bad, 1, 0.004, False, t0, device="cpu")
    assert time.perf_counter() - t0 < 120


def test_the_cell_asks_for_four_chips():
    """The cell's files: four ranks of the paper's GCN; the cell is not
    declared (its ``step_ms`` spreads too widely between runs)."""
    traffic = json.loads((ROOT / "perfbench/traffic/part4.json").read_text())
    assert traffic["driver"] == "train_gnn_part"
    assert traffic["partitions"] == 4
    cfg = json.loads((ROOT / "perfbench/configs/gcn.json").read_text())
    assert cfg["dims"] == [16, 64, 64, 64, 64, 16]
    with pytest.raises(KeyError):
        bench.load_cell(CELL)
