"""CPU tests of the benchmark (run them from the checkout's root:
``python -m pytest -q perfbench/test_perfbench.py``; the repository's own
test run collects ``tests/`` only).  Cells run here at a tiny size on the
CPU, where the program runs its kernels' plain versions; the cases marked
``cuda`` run on a card (``-m cuda``)."""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import bench, work  # noqa: E402

TINY_TRAFFIC = {"driver": "train_gnn", "generator": "rmat", "graph_seed": 3,
                "graph": {"n_log2": 8, "avg_deg": 8}, "train_frac": 0.6}


def _tiny_tree(tmp: Path, configs=("gcn", "gat8h")) -> Path:
    """A copy of the benchmark's folder and ``BENCHMARK.json`` with a
    tiny cell per config (the real cells' limits), made of new files."""
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    (tmp / "perfbench" / "cache").mkdir()
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "perfbench/traffic/tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    for cfg in configs:
        real = json.loads((ROOT / f"perfbench/cells/{cfg}.train.rmat18.json")
                          .read_text())
        name = f"{cfg}.train.tiny"
        b["workloads"].append({"name": name, "config": cfg, "traffic": "tiny",
                               "chips": 1, "why": "a tiny CPU cell"})
        (tmp / f"perfbench/cells/{name}.json").write_text(json.dumps(
            {"nominal_step_ms": 1, "limits": real["limits"]}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp / "perfbench"


def _run_tiny(root: Path, name: str, trace=False, seed=2 ** 31 + 7):
    cell = bench.load_cell(name, root)
    drv = bench.load_module("drivers", cell.traffic["driver"], root)
    return drv.run(cell, seed, 0.004, trace, time.perf_counter(),
                   device="cpu")


@pytest.mark.parametrize("cfg", ["gcn", "gat8h"])
def test_reference_agrees_with_the_port_on_cpu(tmp_path, cfg):
    res, checks = _run_tiny(_tiny_tree(tmp_path, (cfg,)), f"{cfg}.train.tiny")
    assert res["correct"], checks
    assert checks["loss_gap"]["value"] < 1e-5
    assert checks["grad_gap"]["value"] < 1e-5
    assert set(res["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    assert res["attempted"] == 4 and res["failed"] == 0


def _break_state(monkeypatch):
    from repro_torch.apps import gnn
    monkeypatch.setattr(gnn, "adamw_update", lambda p, g, s, c: (p, s))


def _break_half_batch(monkeypatch):
    from repro_torch.apps import gnn
    orig = gnn.node_ce_loss

    def half(logits, labels, mask, total=None):
        odd = torch.zeros_like(mask)
        odd[torch.nonzero(mask)[1::2, 0]] = 1.0
        return orig(logits, labels, mask * (1.0 - odd), total)
    monkeypatch.setattr(gnn, "node_ce_loss", half)


def _break_answer(monkeypatch):
    from repro_torch.kernels.paramspmm import ops
    orig = ops._call

    def lost_block(*a, **kw):
        out = orig(*a, **kw)
        rows = out.shape[-2]
        keep = torch.ones(rows, 1, dtype=out.dtype)
        keep[:max(1, rows // 64)] = 0.0
        return out * keep
    monkeypatch.setattr(ops, "_call", lost_block)


@pytest.mark.parametrize("cfg", ["gcn", "gat8h"])
@pytest.mark.parametrize("fault", [_break_state, _break_half_batch,
                                   _break_answer],
                         ids=["state_unchanged", "half_batch", "answer"])
def test_a_broken_timed_path_reads_not_correct(tmp_path, monkeypatch, cfg,
                                               fault):
    root = _tiny_tree(tmp_path, (cfg,))
    fault(monkeypatch)
    res, checks = _run_tiny(root, f"{cfg}.train.tiny")
    assert not res["correct"], checks


def test_calibrate_reads_the_program_the_control_and_the_faults(tmp_path):
    """``calibrate.py`` on a tiny cell on the CPU (no TF32 there, so the
    control reads as the reference does)."""
    sys.path.insert(0, str(ROOT / "perfbench"))
    try:
        import calibrate
    finally:
        sys.path.remove(str(ROOT / "perfbench"))
    root = _tiny_tree(tmp_path, ("gcn",))
    out = tmp_path / "calib.json"
    calibrate.main(["--workload", "gcn.train.tiny", "--seeds", "1,2",
                    "--control-seeds", "3", "--out", str(out),
                    "--device", "cpu", "--root", str(root)])
    got = json.loads(out.read_text())
    assert set(got["program"]) == {"1", "2"}
    assert max(r["loss_gap"] for r in got["program"].values()) < 1e-5
    assert got["half_batch"]["3"]["loss_gap"] > 1e-3
    assert got["block_lost"]["3"]["grad_gap"] > 1e-3


def test_work_counts_by_hand():
    """A 4-node path 0-1-2-3: Â has 6 + 4 = 10 nonzeros."""
    n, nnz = 4, 10
    a = 4 * (n + 1 + 2 * nnz)                        # 100 bytes of CSR
    assert work.csr_bytes(n, nnz) == a
    assert work.csr_bytes(n, nnz, values=False) == 4 * (n + 1 + nnz)
    ops = work.gcn_step([2, 4, 2], n, nnz)
    spmm = [o for o in ops if o.family == "paramspmm"]
    # layer 0 widens (2 → 4): (Â·X)·W at width 2, no backward SpMM;
    # layer 1 (4 → 2): Â·(H·W) at 2 with the bias, and its Âᵀ product
    assert [(o.width, o.bytes, o.flops) for o in spmm] == [
        (2, a + 2 * 4 * 4 * 2, 2 * 10 * 2),
        (2, a + 2 * 4 * 4 * 2 + 4 * 2, 2 * 10 * 2),
        (2, a + 2 * 4 * 4 * 2, 2 * 10 * 2)]
    mm = [o.flops for o in ops if o.family == "matmul"]
    assert mm == [2 * 4 * 2 * 4] * 2 + [2 * 4 * 4 * 2] * 3
    assert work.model_flops(ops) == sum(mm) + 3 * 40
    least = work.least_s(ops, {"paramspmm"})
    assert least == pytest.approx(sum(o.bytes for o in spmm) / 3.35e12)
    g = work.gat_step([2, 4, 2], n, nnz, heads=2)
    assert work.launches(g) == {"sddmm_softmax": 2, "paramspmm": 8,
                                "sddmm": 2}
    p = 4 * (n + 1 + nnz)
    first = g[6]                      # layer 0's SDDMM → softmax, d 2, H 2
    assert (first.family, first.width, first.heads) == ("sddmm_softmax", 2, 2)
    assert first.bytes == p + 2 * 4 * 2 * 4 * 2 + 4 * 2 * 10 + 2 * 4 * 2 * 4
    assert first.flops == 2 * 2 * 10 * 2
    assert work.kernel_family("void paramspmm_merge_kernel(int const*)") \
        == "paramspmm"
    assert work.kernel_family("sddmm_kernel(int const*, float*)") == "sddmm"
    assert work.kernel_family("sddmm_softmax_kernel(int const*)") \
        == "sddmm_softmax"
    assert work.kernel_family("ampere_sgemm_128x64_nn") == "other"


def test_frozen_generators_match_the_programs():
    from perfbench.graphs import kregular, rmat
    from repro_torch.data import graphs
    for mod, prog, kw in ((rmat, graphs.rmat, dict(n_log2=9, avg_deg=12)),
                          (kregular, graphs.kregular, dict(n=700, k=8))):
        indptr, indices, n = mod.generate(17, **kw)
        want = prog(seed=17, **kw)
        assert n == want.n_rows
        assert np.array_equal(indptr, want.indptr)
        assert np.array_equal(indices, want.indices)


def test_a_new_cell_from_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric
    added as files, with their entries in BENCHMARK.json."""
    root = _tiny_tree(tmp_path, ())
    (root / "configs/gcn3.json").write_text(json.dumps({
        **json.loads((root / "configs/gcn.json").read_text()),
        "dims": [16, 32, 32, 16]}))
    (root / "traffic/er.json").write_text(json.dumps(
        {**TINY_TRAFFIC, "graph": {"n_log2": 7, "avg_deg": 6}}))
    (root / "cells/gcn3.train.er.json").write_text(json.dumps(
        {"nominal_step_ms": 1,
         "limits": {"loss_gap": 1e-5, "grad_gap": 1e-4,
                    "change_gap": 1e-4}}))
    (root / "metrics/window_steps.py").write_text(
        "def read(ctx):\n    return float(len(ctx.cell.name))\n")
    b = json.loads((root.parent / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "gcn3", "source": "a test",
                         "file": "perfbench/configs/gcn3.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "gcn3.train.er", "config": "gcn3",
                           "traffic": "er", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "window_steps", "unit": "1",
                           "better": "higher", "source": "program_counter",
                           "layer": "harness", "moves": "step_ms",
                           "workloads": ["gcn3.train.er"]})
    pack = next(m for m in b["per_layer"] if m["name"] == "pack_s")
    pack["workloads"].append("gcn3.train.er")
    (root.parent / "BENCHMARK.json").write_text(json.dumps(b))
    res, checks = _run_tiny(root, "gcn3.train.er", trace=True)
    assert res["correct"], checks
    assert res["metrics"]["window_steps"]["value"] == len("gcn3.train.er")
    assert set(res["metrics"]) == {"window_steps", "pack_s"}
    assert res["metrics"]["pack_s"]["value"] > 0


def test_no_module_of_jax_or_the_jax_package_is_loaded(tmp_path):
    """A whole CPU run in a fresh process: every loaded module's
    top-level name, compared whole, is neither jax nor repro."""
    root = _tiny_tree(tmp_path, ("gat8h",))
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from perfbench import bench\n"
        f"cell = bench.load_cell('gat8h.train.tiny', __import__('pathlib')"
        f".Path({str(root)!r}))\n"
        "drv = bench.load_module('drivers', 'train_gnn', cell.root)\n"
        "res, checks = drv.run(cell, 5, 0.004, True, time.perf_counter(),"
        " device='cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "perfbench" in top
    assert not top & set(bench.FORBIDDEN), top & set(bench.FORBIDDEN)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "reproducible", object())
    found = bench.forbidden_modules()
    assert "repro.core" in found and "reproducible" not in found
    assert not any(m.startswith("repro_torch") for m in found)


def test_run_refuses_a_machine_without_the_card(tmp_path):
    """No CUDA device: a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(ROOT / "perfbench/run.py"),
                          "--workload", "gcn.train.rmat18", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_device_idle_reads_busy_time_a_step_against_unprofiled_steps():
    """2 profiled steps with 6 ms of device ops (one overlap) against an
    unprofiled step of 5 ms: 40% idle, whatever the profiled steps took."""
    from types import SimpleNamespace

    from perfbench import devtrace
    idle = bench.load_module("metrics", "device_idle")
    prof = devtrace.DeviceWindow(2, [("a", 0.0, 0.004), ("b", 0.003, 0.002),
                                     ("c", 0.5, 0.001)])
    assert prof.busy_s == pytest.approx(0.006)
    ctx = SimpleNamespace(prof=prof, step_s=0.005)
    assert idle.read(ctx) == pytest.approx(40.0)
    assert idle.read(SimpleNamespace(prof=None, step_s=0.005)) is None


def test_nearest_rank_and_judge():
    assert bench.nearest_rank(range(1, 101), 0.95) == 95
    assert bench.nearest_rank([3.0], 0.95) == 3.0
    assert bench.judge({"a": {"value": 1e-7, "limit": 1e-6}})
    assert not bench.judge({"a": {"value": math.nan, "limit": 1e-6}})
    assert not bench.judge({"a": {"value": 1, "limit": 0}})


@pytest.mark.cuda
def test_the_tf32_control_reads_not_correct():
    """The reference with TF32 matmuls in the program's place, on a
    65,536-node R-MAT graph at gcn's and gat8h's widths: some number
    passes its cell's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench.graphs import rmat
    drv = bench.load_module("drivers", "train_gnn")
    ref = bench.load_module("reference", "gnn")
    indptr, indices, n = rmat.generate(1, n_log2=16, avg_deg=32)
    adj = ref.Adjacency(indptr, indices, n, "cuda")
    for cfg in ("gcn", "gat8h"):
        cell = bench.load_cell(f"{cfg}.train.rmat18")
        X, labels, train, _, p0 = drv.make_inputs(cell, n, 3, "cuda")
        base = ref.train(cell.config, p0, X, labels, train, adj, 3)
        ctl = ref.train(cell.config, p0, X, labels, train, adj, 3,
                        use_tf32=True)
        gaps = drv.compare(p0, *ctl, base)
        limits = cell.spec["limits"]
        assert any(gaps[k] > limits[k] for k in limits), (cfg, gaps)
