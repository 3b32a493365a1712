"""CPU tests of the published GAT's cell (``configs/gatppi.json``,
``drivers/train_gat_ppi.py``, ``reference/gat_ppi.py``, ``work_gat.py``
and the ``gatppi_*`` readers); run them from the checkout's root:
``python -m pytest -q perfbench/test_gat_ppi.py``.  The cell runs here on
a tiny graph at the configuration's own widths, on the CPU, where the
program runs its kernels' plain versions."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT, ROOT / "tests"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import bench, devtrace, work, work_gat  # noqa: E402

CELL = "gatppi.train.rmat18ml"
TINY = {"driver": "train_gat_ppi", "generator": "rmat", "graph_seed": 3,
        "graph": {"n_log2": 7, "avg_deg": 8}, "train_frac": 0.6}


# The tiny cell's limits.  On 128 nodes the 1,024-wide model fits its
# random labels fast (the loss falls 0.74 → 0.47 in 3 steps), and Adam's
# normalised step moves parameters whose gradients are at rounding level
# by ±lr, so the losses of steps 1–2 part by 1.5–3.9e-6 (relative) from
# the reference's while the first gradients agree to 3.5e-7: the
# loss_gap limit is 2e-5 here, above those readings, and the faults read
# 1e-3 or more.
TINY_LIMITS = {"loss_gap": 2e-5, "grad_gap": 1e-5, "grad_gap_att": 1e-5,
               "change_gap": 1e-3}


def _tiny_tree(tmp: Path) -> Path:
    """A copy of the benchmark with a tiny multi-label cell of the
    configuration."""
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    (tmp / "perfbench" / "cache").mkdir()
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "perfbench/traffic/tinyml.json").write_text(json.dumps(TINY))
    name = "gatppi.train.tinyml"
    b["workloads"].append({"name": name, "config": "gatppi",
                           "traffic": "tinyml", "chips": 1,
                           "why": "a tiny CPU cell"})
    for m in b["per_layer"]:
        if CELL in m["workloads"]:
            m["workloads"].append(name)
    (tmp / f"perfbench/cells/{name}.json").write_text(json.dumps(
        {"nominal_step_ms": 1, "limits": TINY_LIMITS}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp / "perfbench"


def _run(root, trace=False, seed=2 ** 31 + 11):
    cell = bench.load_cell("gatppi.train.tinyml", root)
    drv = bench.load_module("drivers", cell.traffic["driver"], root)
    return drv.run(cell, seed, 0.003, trace, time.perf_counter(),
                   device="cpu")


def test_the_cell_holds_the_published_widths():
    cell = bench.load_cell(CELL)
    assert cell.config["dims"] == [50, 1024, 1024, 121]
    assert cell.config["heads"] == [4, 4, 6]
    assert cell.chips == 1
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in b["configs"] if c["name"] == "gatppi")
    assert entry["reduced"] == [] and cell.config["reduced"] == []
    assert {m["name"] for m in cell.per_layer} == {
        "gatppi_spmm_roofline", "gatppi_sddmm_roofline", "gatppi_step_mfu",
        "gatppi_gemm_ms", "gatppi_step_host_ms", "gatppi_device_idle",
        "gatppi_other_device_ms", "gatppi_forward_idle_ms",
        "gatppi_backward_idle_ms", "gatppi_optimizer_idle_ms",
        "gatppi_pack_s", "gatppi_reorder_s", "gatppi_pick_s",
        "gatppi_pcsr_s", "gatppi_transpose_side_s"}
    assert set(cell.spec["limits"]) == {"loss_gap", "grad_gap",
                                        "grad_gap_att", "change_gap"}


def test_reference_agrees_with_the_port_on_cpu(tmp_path):
    res, checks = _run(_tiny_tree(tmp_path))
    assert res["correct"], checks
    assert checks["grad_gap"]["value"] < 1e-6
    assert set(res["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    assert res["attempted"] == 3 and res["failed"] == 0


def test_a_traced_cpu_run_reads_the_host_span_metric(tmp_path):
    res, checks = _run(_tiny_tree(tmp_path), trace=True)
    assert res["correct"], checks
    # no device trace on the CPU: only the span readers read
    assert set(res["metrics"]) == {
        "gatppi_step_host_ms", "gatppi_pack_s", "gatppi_reorder_s",
        "gatppi_pick_s", "gatppi_pcsr_s", "gatppi_transpose_side_s"}
    assert res["metrics"]["gatppi_step_host_ms"]["value"] > 0
    assert res["metrics"]["gatppi_pack_s"]["value"] >= \
        res["metrics"]["gatppi_pcsr_s"]["value"] > 0


def test_the_attention_vectors_are_held_apart():
    """``grad_gap`` reads the weights and biases, ``grad_gap_att`` the
    attention vectors; each leaf's gap as ``train_gnn.py`` reads it."""
    drv = bench.load_module("drivers", "train_gat_ppi")
    ones = lambda *s: torch.ones(*s)
    p0 = [{"w": ones(2, 2), "al": ones(1, 2), "ar": ones(1, 2),
           "b": ones(2)}]
    p3 = [{k: 2 * v for k, v in p0[0].items()}]
    ref = ([1.0, 1.0, 1.0], p0, p3)
    grads = [{"w": ones(2, 2), "al": ones(1, 2) * 1.5, "ar": ones(1, 2),
              "b": ones(2) * 1.001}]
    r = drv.compare(p0, [1.0, 1.0, 1.0], grads, p3, ref)
    assert r["change_gap"] == 0.0 and r["loss_gap"] == 0.0
    assert r["grad_gap_att"] == pytest.approx(0.5, rel=1e-5)
    assert r["grad_gap"] == pytest.approx(1e-3, rel=1e-3)
    assert "grad_leaves" not in r


def _break_state(monkeypatch):
    from repro_torch.apps import gnn
    monkeypatch.setattr(gnn, "adamw_update", lambda p, g, s, c: (p, s))


def _break_half_batch(monkeypatch):
    from repro_torch.apps import gnn
    orig = gnn.node_bce_loss

    def half(logits, labels, mask, total=None):
        odd = torch.zeros_like(mask)
        odd[torch.nonzero(mask)[1::2, 0]] = 1.0
        return orig(logits, labels, mask * (1.0 - odd), total)
    monkeypatch.setattr(gnn, "node_bce_loss", half)


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


@pytest.mark.parametrize("fault", [_break_state, _break_half_batch,
                                   _break_answer],
                         ids=["state_unchanged", "half_batch", "answer"])
def test_a_broken_timed_path_reads_not_correct(tmp_path, monkeypatch,
                                               fault):
    root = _tiny_tree(tmp_path)
    fault(monkeypatch)
    res, checks = _run(root)
    assert not res["correct"], checks


def test_the_two_references_agree():
    """``reference/gat_ppi.py`` (edge blocks, a head at a time) against
    the tests' ``plain_gat_additive.py`` on a small graph: the same
    losses, gradients and parameters after 2 steps."""
    import plain_gat_additive as plain
    from perfbench.graphs import rmat
    ref = bench.load_module("reference", "gat_ppi")
    cfg = json.loads((ROOT / "perfbench/configs/gatppi.json").read_text())
    cfg = dict(cfg, dims=[6, 16, 16, 5], heads=[4, 4, 3])
    indptr, indices, n = rmat.generate(5, n_log2=6, avg_deg=6)
    gen = torch.Generator().manual_seed(1)
    drv = bench.load_module("drivers", "train_gat_ppi")
    params = drv.init_params(cfg, gen, "cpu")
    X = torch.randn((n, 6), generator=gen)
    labels = (torch.rand((n, 5), generator=gen) < 0.5).float()
    mask = (torch.rand(n, generator=gen) < 0.6).float()
    old = ref.EDGE_BLOCK
    ref.EDGE_BLOCK = 97                   # several blocks
    try:
        a = ref.train(cfg, params, X, labels, mask,
                      ref.Adjacency(indptr, indices, n, "cpu"), 2)
    finally:
        ref.EDGE_BLOCK = old
    rows, cols = plain.edges(indptr, indices, n)
    b = plain.train(params, X, labels, mask, rows, cols, 2, lr=0.005)
    assert a[0] == pytest.approx(b[0], rel=1e-6)
    for ga, gb in zip(a[1] + a[2], b[1] + b[2]):
        for k in gb:
            torch.testing.assert_close(ga[k], gb[k], atol=1e-6, rtol=1e-5)


def test_work_counts_by_hand():
    """3 layers, heads (2, 2, 3) of widths (4, 4, 5) on 4 nodes and 10
    nonzeros of A + I."""
    n, nnz = 4, 10
    ops = work_gat.step_ops({"dims": [3, 8, 8, 5], "heads": [2, 2, 3]}, n,
                            nnz)
    assert work.launches(ops) == {"sddmm_softmax": 3, "paramspmm": 12,
                                  "sddmm": 3}
    p = 4 * (n + 1 + nnz)
    stats = [o for o in ops if o.family == "sddmm_softmax"]
    # the 2-wide operands: Q and K read, logits written, stats written
    assert [(o.width, o.heads) for o in stats] == [(2, 2), (2, 2), (2, 3)]
    H = 3
    assert stats[2].bytes == p + 2 * 4 * H * n * 2 + 4 * H * nnz \
        + 2 * 4 * H * n
    agg = [o for o in ops if o.what.endswith("α·V d=5")][0]
    assert agg.flops == 2 * H * nnz * 5
    assert agg.bytes == p + 4 * H * nnz + 2 * 4 * H * n + 2 * 4 * H * n * 5
    mm = [o.flops for o in ops if o.family == "matmul"]
    assert mm == [2 * n * 3 * 8] * 2 + [2 * n * 8 * 8] * 3 \
        + [2 * n * 8 * 15] * 3
    assert work_gat.gemm_flops(ops) == sum(mm)


def test_gemm_reader_takes_dense_kernels_only():
    gemm = bench.load_module("metrics", "gatppi_gemm_ms")
    prof = devtrace.DeviceWindow(2, [
        ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", 0.0, 0.004),
        ("void cutlass::Kernel2<cutlass_80_simt_sgemm>", 0.01, 0.002),
        ("void paramspmm_kernel<1, 4, false>(int const*)", 0.02, 0.003),
        ("void at::native::elementwise_kernel<128>", 0.03, 0.001)])
    assert gemm.read(SimpleNamespace(prof=prof)) == pytest.approx(3.0)
    assert gemm.read(SimpleNamespace(prof=None)) is None


def test_a_program_without_additive_attention_is_refused_at_once():
    drv = bench.load_module("drivers", "train_gat_ppi")

    def train_gnn(task, *, model="gcn", heads=1, device=None):
        pass
    with pytest.raises(RuntimeError, match="additive"):
        drv.check_program(train_gnn)
    from repro_torch.apps.gnn import train_gnn as real
    drv.check_program(real)


def test_calibrate_reads_the_program_the_control_and_the_faults(tmp_path):
    """``calibrate_gat_ppi.py`` on the tiny cell on the CPU (no TF32 there,
    so the control reads as the reference does)."""
    sys.path.insert(0, str(ROOT / "perfbench"))
    try:
        import calibrate_gat_ppi
    finally:
        sys.path.remove(str(ROOT / "perfbench"))
    root = _tiny_tree(tmp_path)
    out = tmp_path / "calib.json"
    calibrate_gat_ppi.main(["--workload", "gatppi.train.tinyml", "--seeds",
                            "1,2", "--control-seeds", "3", "--out", str(out),
                            "--device", "cpu", "--root", str(root)])
    got = json.loads(out.read_text())
    assert set(got["program"]) == {"1", "2"}
    assert max(r["grad_gap"] for r in got["program"].values()) < 1e-6
    assert got["control"]["3"]["loss_gap"] == 0.0
    assert got["half_batch"]["3"]["loss_gap"] > 1e-3
    assert got["block_lost"]["3"]["grad_gap"] > 1e-3
