"""Package boundaries of the PyTorch port.

``repro_torch``, ``chip_smoke.py`` and ``chip_compare.py`` import
neither JAX nor the JAX package ``repro`` (the port keeps its own copy of
what it needs); only the ``tests/test_torch_*`` files import both.  Entry
points run on the card unless the caller asks for the CPU.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                           ROOT / "chip_compare.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print(' '.join(names))\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 61
    # the decider path, the baselines, the capture path, the distributed
    # path and the dynamic-graph path are among them
    assert set(DECIDER_PATH) | set(CAPTURE_PATH) | set(DIST_PATH) \
        | set(DYNAMIC_PATH) | set(TRAIN_PATH) <= set(res.stdout.split())


DECIDER_PATH = ("repro_torch.obs.decisions", "repro_torch.core.features",
                "repro_torch.core.decider", "repro_torch.core.calibrate",
                "repro_torch.core.autotune", "repro_torch.core.baselines",
                "repro_torch.apps.decider_train")


# the graph-capture slice: the captured serving and decode paths' helper
# and the trace reader (a copy of the reference's, which imports no JAX
# but is the reference's all the same)
CAPTURE_PATH = ("repro_torch.kernels.capture", "repro_torch.apps.obs_report",
                "repro_torch.serve.forward", "repro_torch.launch.serve")


# the distributed slice: partitioned training over torch.distributed
DIST_PATH = ("repro_torch.dist", "repro_torch.dist.partition",
             "repro_torch.dist.halo", "repro_torch.dist.comm",
             "repro_torch.dist.packing", "repro_torch.dist.spmm",
             "repro_torch.dist.gat")


# the dynamic-graph slice: mutated layouts, the governor, DistGraph.refresh
DYNAMIC_PATH = ("repro_torch.dynamic", "repro_torch.dynamic.pcsr",
                "repro_torch.dynamic.governor", "repro_torch.dynamic.graph",
                "repro_torch.dynamic.dist")


# the LM-training slice: loss, optimiser trees, compression, data,
# checkpoints, the train entry point, the GNN config modules
TRAIN_PATH = ("repro_torch.launch.train", "repro_torch.checkpoint",
              "repro_torch.checkpoint.manager", "repro_torch.data.tokens",
              "repro_torch.optim.compression", "repro_torch.optim.adamw",
              "repro_torch.models.lm", "repro_torch.obs.trace",
              "repro_torch.configs.gcn", "repro_torch.configs.gin",
              "repro_torch.configs.gat")


@pytest.mark.parametrize("name", TRAIN_PATH)
def test_train_path_modules_are_checked(name):
    rel = name.split(".", 1)[1].replace(".", "/")
    path = PORT / (rel + ("/__init__.py" if name == "repro_torch.checkpoint"
                          else ".py"))
    assert path in PORT_FILES
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_train_entry_point_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--reduced", "--steps", "1"],
                 ["--reduced", "--steps", "1", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(argv)


@pytest.mark.parametrize("name", DIST_PATH + DYNAMIC_PATH)
def test_dist_path_modules_are_checked(name):
    rel = name.split(".", 1)[1].replace(".", "/")
    path = PORT / (rel + ("/__init__.py" if name in ("repro_torch.dist",
                                                     "repro_torch.dynamic")
                          else ".py"))
    assert path in PORT_FILES
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("name", CAPTURE_PATH)
def test_capture_path_modules_are_checked(name):
    path = PORT / (name.split(".", 1)[1].replace(".", "/") + ".py")
    assert path in PORT_FILES
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("name", DECIDER_PATH)
def test_decider_path_modules_are_checked(name):
    path = PORT / (name.split(".", 1)[1].replace(".", "/") + ".py")
    assert path in PORT_FILES
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.apps.serve_gnn import main
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)
    assert resolve_device("cpu") == torch.device("cpu")
    for model in ("gcn", "gat"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--requests", "2", "--model", model])
    from repro_torch.data.graphs import er
    from repro_torch.models.gnn import init_gat
    from repro_torch.serve import GNNService
    g = er(50, 4, seed=0)
    params = init_gat([8, 8, 4], generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GNNService(g, np.ones((50, 8), np.float32), params, model="gat")
    from repro_torch.apps import gnn as gnn_app
    from repro_torch.data.tasks import community_task
    from repro_torch.pipeline import ParamSpMM
    task = community_task(n_blocks=2, block_size=16)
    for model in ("gcn", "gat"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gnn_app.train_gnn(task, model=model, steps=1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gnn_app.main(["--model", model, "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ParamSpMM(task.csr, 16)
    for mode in ("cusparse", "gespmm"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gnn_app.train_gnn(task, steps=1, spmm_mode=mode)
    from repro_torch.apps import decider_train
    from repro_torch.core import calibrate
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decider_train.main(["--scale", "small", "--dims", "16"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibrate.main(["--fast"])
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = get_reduced("hymba-1.5b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--gen", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_params(cfg, generator=torch.Generator())
    params = lm.init_params(cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.generate(cfg, params, np.zeros((1, 2), np.int64), 3, 1)


def test_kernel_sources_build_targets_hopper():
    from repro_torch.kernels import build
    assert build.sources() == ["gat_backward", "paramspmm", "sddmm",
                               "sddmm_softmax", "selective_scan"]
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
    for name, tpu in (("paramspmm", "paramspmm/kernel.py"),
                      ("sddmm", "sddmm/kernel.py::sddmm_kernel"),
                      ("sddmm_softmax", "sddmm/kernel.py"),
                      ("selective_scan", "selective_scan/kernel.py::"
                                         "selective_scan_kernel")):
        src = (build.CSRC_DIR / f"{name}.cu").read_text()
        assert "torch/extension.h" not in src
        assert f"src/repro/kernels/{tpu}" in src
    # the GAT backward's slot pass replaces no TPU kernel, and says so
    src = (build.CSRC_DIR / "gat_backward.cu").read_text()
    assert "torch/extension.h" not in src
    assert "Replaces no TPU kernel" in src
    # the build directory is one git ignores
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA — and in a directory holding nothing else of the
    repo — ``chip_smoke.py`` exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the card-less path")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


def test_plain_path_is_taken_only_for_cpu_tensors():
    from repro_torch.core.pcsr import SpMMConfig, build_pcsr
    from repro_torch.kernels.paramspmm import ops
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    A = np.eye(8, dtype=np.float32)
    from repro_torch.core.sparse import CSRMatrix
    c = CSRMatrix.from_dense(A)
    p = build_pcsr(c.indptr, c.indices, c.data, 8, 8, SpMMConfig())
    B = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    assert torch.equal(ops.paramspmm(p, B), B)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.paramspmm(p, B.to("meta"))
    # one edge per row: every row's softmax is α = 1, so A·B = B again
    lg, rm, rs = sddmm_ops.sddmm_softmax_stats(p, B, B)
    assert torch.equal(ops.paramspmm_with_vals(p, lg, B, stats=(rm, rs)), B)
    with pytest.raises(ValueError, match="cpu or cuda"):
        sddmm_ops.sddmm_softmax_stats(p, B.to("meta"), B.to("meta"))
    # the raw SDDMM: one edge per row, so each row's score is B[i]·B[i]
    launches = sddmm_ops.launch_count("sddmm")
    E = sddmm_ops.sddmm(p, B, B)
    assert sddmm_ops.launch_count("sddmm") == launches
    assert torch.equal(E.flatten().sort().values,
                       (B * B).sum(-1).sort().values)
    with pytest.raises(ValueError, match="cpu or cuda"):
        sddmm_ops.sddmm(p, B.to("meta"), B.to("meta"))
    # the selective scan: one step with dA = 0 gives y = Σ_n dBx·C
    from repro_torch.kernels import selective_scan as scan
    launches = scan.launch_count()
    dBx = torch.arange(12, dtype=torch.float32).reshape(1, 1, 3, 4)
    y = scan.selective_scan(torch.zeros_like(dBx), dBx, torch.ones(1, 1, 3))
    assert scan.launch_count() == launches
    assert torch.equal(y, dBx.sum(2))
    with pytest.raises(ValueError, match="cpu or cuda"):
        scan.selective_scan(*(t.to("meta") for t in (dBx, dBx,
                                                     torch.ones(1, 1, 3))))
