"""The port's dry run (``repro_torch.launch.dryrun``, ``report``)
against the JAX package's.

* The extrapolation arithmetic (``_vec``, ``_unflatten_cost``), the
  bilinear RWKV fit on synthetic cost dicts and ``_layer_variants``
  equal the reference's functions.
* For reduced chatglm3 and hymba train cells on a (4, 4) mesh, the
  port's per-device argument bytes equal the reference's
  ``compile_cell(...).memory_analysis().argument_size_in_bytes`` over 16
  forced host devices (a subprocess), and a fake-process-group run of
  each cell (another subprocess) counts FLOPs, bytes and collectives.
* ``--opt ssm_scan_dtype=bfloat16`` runs hymba's train_4k cell (reduced
  config, 256 fake ranks) through the CLI, and on the 4×4 cell its
  argument bytes equal the reference's under the same option.
* ``report.py`` turns a record into the reference's table rows.
"""
import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import report as treport

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = ("t", 64, 16, "train")          # ShapeCell fields: S, global batch
SIZES = {"data": 4, "model": 4}


@pytest.fixture(scope="module")
def rdry():
    """The reference's dry-run module, imported without letting its
    512-device ``XLA_FLAGS`` leak into this process's environment."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def test_linear_extrapolation_math(rdry):
    """``tests/test_launch_units.py``'s case, in both packages."""
    base = {"flops": 10.0, "bytes": 100.0, "coll::all-reduce::b": 8.0}
    var = {"flops": 14.0, "bytes": 130.0, "coll::all-reduce::b": 10.0}
    for mod in (tdry, rdry):
        delta = mod._vec(lambda v, b: v - b, var, base)
        total = mod._vec(lambda t, d: t + (5 - 1) * d, base, delta)
        out = mod._unflatten_cost(total)
        assert out["flops"] == 26.0 and out["bytes"] == 220.0
        assert out["coll"]["all-reduce"][1] == 16
    assert tdry._unflatten_cost(total) == rdry._unflatten_cost(total)


def _synthetic(L, S, key=0.0):
    """A cost dict bilinear in (L, S) with a collective kind that only
    shows up from L = 2."""
    out = {"flops": 7.0 + 3 * L + 0.5 * S + 0.25 * L * S + key,
           "bytes": 100.0 + 11 * L + 2 * S + L * S,
           "coll::all-reduce::n": float(2 * L),
           "coll::all-reduce::b": 64.0 * L * S}
    if L > 1:
        out["coll::all-gather::b"] = 8.0 * S
    return out


@pytest.mark.parametrize("arch,shape", [("rwkv6-1.6b", "train_4k"),
                                        ("rwkv6-1.6b", "prefill_32k")])
def test_rwkv_bilinear_cost_equals_reference(rdry, monkeypatch, arch,
                                             shape):
    """The fit from four (L, S) runs, fed the same synthetic costs."""
    from repro.configs import get_config as rconfig
    from repro.configs.base import SHAPES as RSHAPES
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    monkeypatch.setattr(rdry, "compile_cell",
                        lambda cfg, cell, mesh, **kw: (cfg.n_layers,
                                                       cell.seq_len))
    monkeypatch.setattr(rdry, "_cost", lambda ls: _synthetic(*ls))
    want = rdry._rwkv_bilinear_cost(rconfig(arch), RSHAPES[shape], None)
    got = tdry._unflatten_cost(tdry._rwkv_bilinear_cost(
        get_config(arch), SHAPES[shape], None,
        count=lambda cfg, cell: _synthetic(cfg.n_layers, cell.seq_len)))
    assert got == want
    L, S = get_config(arch).n_layers, SHAPES[shape].seq_len
    assert got["flops"] == _synthetic(L, S)["flops"]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-tiny",
                                  "chatglm3-6b", "granite-moe-3b-a800m"])
def test_layer_variants_equal_reference(rdry, arch):
    from repro.configs import get_config as rconfig
    from repro_torch.configs import get_config
    rb, rv = rdry._layer_variants(rconfig(arch))
    tb, tv = tdry._layer_variants(get_config(arch))
    assert dataclasses.asdict(tb) == dataclasses.asdict(rb)
    assert [(n, dataclasses.asdict(c)) for n, c in tv] == [
        (n, dataclasses.asdict(c)) for n, c in rv]


# ------------------------------------------- argument bytes and a fake run
REF_SCRIPT = textwrap.dedent('''
    import json, sys
    import jax
    from repro.configs import get_reduced
    from repro.configs.base import ShapeCell
    from repro.launch.dryrun import compile_cell
    from repro.launch.mesh import _axis_type_kwargs
    from repro.models import sharding_ctx
    mesh = jax.make_mesh((4, 4), ("data", "model"), **_axis_type_kwargs(2))
    out = {}
    opts = json.loads(sys.argv[2])
    for arch in sys.argv[3:]:
        cell = ShapeCell(*json.loads(sys.argv[1]))
        ma = compile_cell(get_reduced(arch), cell, mesh,
                          opts=opts).memory_analysis()
        out[arch] = int(ma.argument_size_in_bytes)
        sharding_ctx.set_mesh(None)
    print(json.dumps(out))
''')

FAKE_SCRIPT = textwrap.dedent('''
    import json, sys
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    mesh = dryrun.fake_mesh({"data": 4, "model": 4}, "cpu")
    out = {}
    for arch in sys.argv[2:]:
        cfg, cell = get_reduced(arch), ShapeCell(*json.loads(sys.argv[1]))
        flat = dryrun.run_step(cfg, cell, mesh)
        out[arch] = {"cost": flat,
                     "arg_bytes": dryrun.arg_bytes(cfg, cell, mesh)}
    print(json.dumps(out))
''')

ARCHS = ("chatglm3-6b", "hymba-1.5b")


@pytest.fixture(scope="module")
def subprocess_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=16 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    return _run_scripts(env, (REF_SCRIPT, [json.dumps(CELL), "{}", *ARCHS]),
                        (FAKE_SCRIPT, [json.dumps(CELL), *ARCHS]))


def _run_scripts(env, *scripts):
    """Each (script, argv) in a subprocess, side by side: the JSON of each
    one's last line of output."""
    procs = [subprocess.Popen([sys.executable, "-c", script, *args], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for script, args in scripts]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    return outs


@pytest.mark.parametrize("arch", ARCHS)
def test_arg_bytes_equal_reference(subprocess_runs, arch):
    reference, fake = subprocess_runs
    cfg, cell = get_reduced(arch), ShapeCell(*CELL)
    assert tdry.arg_bytes(cfg, cell, SIZES) == reference[arch]
    assert fake[arch]["arg_bytes"] == reference[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_fake_run_counts_per_rank(subprocess_runs, arch):
    """The fake run's FLOPs per rank lie between the model FLOPs' share of
    one of the 16 ranks and twice it (remat recomputes the forward: 8/6
    of 6·N·tokens, plus attention), its bytes exceed the arguments it
    must read, and the TP sums show up as all-reduces."""
    from repro_torch.launch import roofline
    _, fake = subprocess_runs
    cfg, cell = get_reduced(arch), ShapeCell(*CELL)
    cost = fake[arch]["cost"]
    share = roofline.model_flops_for(cfg, cell) / 16
    assert share < cost["flops"] < 2.5 * share
    assert cost["bytes"] > fake[arch]["arg_bytes"]
    assert cost["coll::all-reduce::n"] > 0 and cost["temp_bytes"] > 0


# the port's dry-run CLI on hymba's train_4k cell of the single pod (256
# fake ranks) under the option, at the reduced config (a full-size
# config is not traced in these tests), and its fake run on CELL at 4×4
FAKE_OPT_SCRIPT = textwrap.dedent('''
    import json, os, sys
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    arch, out_dir, opt = sys.argv[2], sys.argv[3], sys.argv[4]
    dryrun.get_config = get_reduced
    dryrun.main(["--arch", arch, "--shape", "train_4k", "--mesh", "single",
                 "--opt", opt, "--out", out_dir])
    with open(os.path.join(out_dir, arch + "_train_4k_single.json")) as f:
        rec = json.load(f)
    mesh = dryrun.fake_mesh({"data": 4, "model": 4}, "cpu")
    k, v = opt.split("=")
    cfg, cell = get_reduced(arch), ShapeCell(*json.loads(sys.argv[1]))
    flat = dryrun.run_step(cfg, cell, mesh, opts={k: v})
    print(json.dumps({"record": rec, "cost": flat, "arg_bytes":
                      dryrun.arg_bytes(cfg, cell, mesh, opts={k: v})}))
''')


def test_scan_dtype_option_runs_and_keeps_arg_bytes(tmp_path):
    """``--opt ssm_scan_dtype=bfloat16``: the CLI runs hymba's train_4k
    cell of the single pod (reduced config) and records the option; its
    argument bytes are the cell's without the option, and on CELL at 4×4
    the fake run's equal the reference's ``compile_cell`` under the same
    option (the option changes no argument)."""
    from repro_torch.configs.base import SHAPES
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=16 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    opt = {"ssm_scan_dtype": "bfloat16"}
    reference, port = _run_scripts(
        env, (REF_SCRIPT, [json.dumps(CELL), json.dumps(opt), "hymba-1.5b"]),
        (FAKE_OPT_SCRIPT, [json.dumps(CELL), "hymba-1.5b", str(tmp_path),
                           "ssm_scan_dtype=bfloat16"]))
    rec, cfg = port["record"], get_reduced("hymba-1.5b")
    assert rec["ok"] and rec["opts"] == opt and rec["n_devices"] == 256
    assert rec["flops"] > 0 and rec["temp_bytes"] > 0
    assert rec["arg_bytes"] == tdry.arg_bytes(cfg, SHAPES["train_4k"],
                                              tdry.MESHES["single"])
    assert port["arg_bytes"] == reference["hymba-1.5b"]
    assert port["cost"]["flops"] > 0


def _record():
    return {"arch": "qwen2-72b", "shape": "train_4k", "mesh": "single",
            "ok": True, "compile_s": 12.3, "per_device_bytes": 3 * 2**30,
            "arg_bytes": 2 * 2**30, "temp_bytes": 2**30,
            "coll_detail": {"all-reduce": [4, 1024], "all-gather": [2, 64]},
            "t_compute": 0.5, "t_memory": 0.25, "t_collective": 1.5,
            "bottleneck": "collective", "model_flops": 1.2e18,
            "useful_ratio": 0.731}


def test_report_rows_equal_reference():
    from repro.launch import report as rreport
    rec = _record()
    bad = {"arch": "rwkv6-1.6b", "shape": "train_4k", "mesh": "multi",
           "ok": False, "error": "RuntimeError: boom"}
    assert treport.dryrun_table([rec, bad]) == rreport.dryrun_table(
        [rec, bad])
    for mesh in ("single", "multi"):
        assert treport.roofline_table([rec, bad], mesh) == \
            rreport.roofline_table([rec, bad], mesh)


def test_report_writes_between_markers(tmp_path):
    d = tmp_path / "records"
    d.mkdir()
    (d / "a.json").write_text(json.dumps(_record()))
    target = tmp_path / "OUT.md"
    target.write_text("head\n" + treport.MARK_A + "\nold\n" + treport.MARK_B
                      + "\ntail\n")
    treport.main(["--dir", str(d), "--target", str(target)])
    text = target.read_text()
    assert text.startswith("head\n") and text.endswith("\ntail\n")
    assert "old" not in text and "| qwen2-72b | train_4k | single |" in text
