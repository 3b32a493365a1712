"""Multi-pod dry run of the LM mesh path: every (arch × shape × mesh)
cell run once on a fake process group, nothing allocated.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference (``repro/launch/dryrun.py``) lowers and compiles each step
for 512 fake XLA host devices and reads ``memory_analysis()`` and
``cost_analysis()``.  Here this process is rank 0 of a fake process
group of 256 (single pod, data 16 × model 16) or 512 ranks (multi-pod,
pod 2 × data 16 × model 16): the step of ``launch/steps.py`` runs on
DTensors whose local shards are fake tensors (``FakeTensorMode``: shapes
and dtypes, no storage), the fake group's collectives return at once,
and ``roofline.cost_counter`` counts rank 0's FLOPs, bytes and
collectives by kind while ``roofline.memory_tracker`` follows its live
tensors.  Per cell:

* ``arg_bytes``: the step's arguments on rank 0 (parameters, AdamW state
  and batch for train; parameters and batch for prefill; parameters,
  token, cache and position for decode), from their local shards;
* ``temp_bytes``: the peak of the tensors the step allocates on rank 0,
  ``per_device_bytes`` = ``arg_bytes`` + ``temp_bytes``;
* ``flops``, ``hbm_bytes`` (operands read plus results written per op:
  eager PyTorch fuses nothing, so this is the unfused count, and
  ``hbm_bytes_raw`` is the same number), ``coll_detail`` and
  ``coll_bytes``; the roofline terms at the H100 data sheet's rates
  (``roofline.PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW``), the
  ``bottleneck``, ``model_flops`` and ``useful_ratio``, under the
  reference's JSON keys.  ``compile_s`` is the seconds of the fake run.

The layer loop is eager Python and counts every layer, so the cost comes
from the one full-depth run; ``--extrapolate`` takes it the reference's
way instead, from L ∈ {1, 2} variants (``_layer_variants``).  RWKV's
time loop (4,096–32,768 steps, three ops a step) is too long to run:
its train and prefill cells take cost and temp bytes from the
reference's bilinear fit over (L, S) (``_rwkv_bilinear_cost``).  Fake
tensors live on CUDA where PyTorch is built with it, else on the CPU (no
card is used either way).  The arguments' specs
are the reference's (``lm.param_specs``: every parameter in bf16), so
``arg_bytes`` is comparable with its ``argument_size_in_bytes``.
Records go to ``--out`` as ``{arch}_{shape}_{mesh}.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, ShapeCell, applicable_shapes
from repro_torch.models import lm
from . import roofline, sharding as sh, steps
from .mesh import make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def default_device() -> str:
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def fake_mesh(sizes: dict, device_type: str):
    """A ``DeviceMesh`` of ``sizes`` (axis name → size) whose rank 0 is
    this process, over a fake process group of as many ranks (restarted
    when the size changes); the production meshes through
    ``mesh.make_production_mesh``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(sizes.values())
    if dist.is_initialized() and (dist.get_backend() != "fake"
                                  or dist.get_world_size() != n):
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running; the dry "
                               "run needs its own fake one")
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    for multi, prod in ((False, MESHES["single"]), (True, MESHES["multi"])):
        if sizes == prod:
            return make_production_mesh(multi_pod=multi,
                                        device_type=device_type)
    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def _fake_tree(specs, place, mesh, device):
    """DTensors of the (shape, dtype) leaves ``specs`` with ``place``,
    each from rank 0's local shard made in the active fake mode."""
    from torch.distributed.tensor import DTensor
    if isinstance(specs, dict):
        return {k: _fake_tree(v, place[k], mesh, device)
                for k, v in specs.items()}
    shape, dtype = specs
    local = torch.empty(sh.local_shape(shape, place, mesh), dtype=dtype,
                        device=device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def cell_args(cfg, cell, mesh, *, opts=None):
    """(name → (specs, placements)) of a cell's step arguments."""
    opts = opts or {}
    params = (lm.param_specs(cfg), sh.param_placements(cfg, mesh))
    if cell.kind == "train":
        ospec = steps.opt_state_specs(cfg)
        oplace = steps.opt_state_placements(cfg, mesh,
                                            zero1=opts.get("zero1", False))
        spec = lm.input_specs(cfg, cell)
        return {"params": params, "opt_state": (ospec, oplace),
                "batch": (spec, sh.batch_placements(spec, mesh))}
    if cell.kind == "prefill":
        spec = lm.input_specs(cfg, cell)
        return {"params": params,
                "batch": (spec, sh.batch_placements(spec, mesh))}
    tok = lm.input_specs(cfg, cell)
    cspec = lm.cache_specs(cfg, cell)
    return {"params": params,
            "token": (tok, sh.batch_placements(tok, mesh)),
            "cache": (cspec, sh.cache_placements(
                cspec, mesh, shard_seq=opts.get("shard_cache_seq", False))),
            "pos": ({"pos": ((), torch.int32)}, {"pos": sh.replicated(mesh)})}


def arg_bytes(cfg, cell, mesh, *, opts=None) -> int:
    """Rank 0's bytes of the cell's step arguments."""
    return sum(sh.local_bytes(s, p, mesh)
               for s, p in cell_args(cfg, cell, mesh, opts=opts).values())


def _set_opts(opts):
    from repro_torch.models.common import (PERF_DEFAULTS, reset_perf_options,
                                           set_perf_options)
    reset_perf_options()
    set_perf_options(**{k: v for k, v in (opts or {}).items()
                        if k in PERF_DEFAULTS})


def run_step(cfg, cell, mesh, *, chunk=1024, opts=None, device="cpu"):
    """One fake run of the cell's step on rank 0: its cost (flat: flops,
    bytes, ``coll::kind::n`` / ``::b``) and ``temp_bytes``."""
    from repro_torch.models.common import set_cost_mode
    opts = opts or {}
    _set_opts(opts)
    counter = roofline.cost_counter()
    tracker = roofline.memory_tracker(counter)
    set_cost_mode(True)
    try:
        with counter:
            args = {k: _fake_tree(s, p, mesh, device)
                    for k, (s, p) in cell_args(cfg, cell, mesh,
                                               opts=opts).items()}
            counter.flops = counter.bytes = 0.0
            counter.coll = {}
            with tracker:
                if cell.kind == "train":
                    st = dict(args["opt_state"], step=0)
                    steps.sharded_train_step(cfg, mesh, chunk=chunk)(
                        args["params"], st, args["batch"])
                elif cell.kind == "prefill":
                    steps.sharded_prefill_step(cfg, mesh, chunk=chunk)(
                        args["params"], args["batch"])
                else:
                    steps.sharded_decode_step(cfg, mesh)(
                        args["params"], args["token"]["token"],
                        args["cache"], args["pos"]["pos"].to_local())
            cost = counter.cost()
    finally:
        set_cost_mode(False)
    flat = {"flops": cost["flops"], "bytes": cost["bytes"],
            "temp_bytes": float(tracker.peak_bytes())}
    for k, (n, b) in cost["coll"].items():
        flat[f"coll::{k}::n"] = float(n)
        flat[f"coll::{k}::b"] = float(b)
    return flat


def _vec(op, *costs):
    keys = set().union(*[c.keys() for c in costs])
    return {k: max(0.0, op(*[c.get(k, 0.0) for c in costs])) for k in keys}


def _unflatten_cost(flat):
    coll = {}
    for k, v in flat.items():
        if k.startswith("coll::"):
            _, kind, field = k.split("::")
            e = coll.setdefault(kind, [0, 0])
            e[0 if field == "n" else 1] = int(v)
    return {"flops": flat.get("flops", 0.0), "bytes": flat.get("bytes", 0.0),
            "bytes_raw": flat.get("bytes_raw", 0.0),
            "coll": {k: tuple(v) for k, v in coll.items()}}


def _layer_variants(cfg):
    """(base_cfg, [(true_count, variant_cfg), ...]) for the layer
    extrapolation: the cost at L ∈ {1, 2} of each kind of layer."""
    if cfg.family == "hybrid":
        base = cfg.replace(n_layers=2, n_global_layers=1)
        return base, [
            (cfg.n_layers - cfg.n_global_layers,
             cfg.replace(n_layers=3, n_global_layers=1)),
            (cfg.n_global_layers,
             cfg.replace(n_layers=3, n_global_layers=2)),
        ]
    if cfg.family == "encdec":
        base = cfg.replace(n_layers=1, n_enc_layers=1)
        return base, [
            (cfg.n_layers, cfg.replace(n_layers=2, n_enc_layers=1)),
            (cfg.n_enc_layers, cfg.replace(n_layers=1, n_enc_layers=2)),
        ]
    base = cfg.replace(n_layers=1)
    return base, [(cfg.n_layers, cfg.replace(n_layers=2))]


def _extrapolated(count, cfg, cell, mesh, *, opts=None):
    """The reference's ``scan_aware_cost`` for the layer stack: base plus
    (count − 1) × (variant − base) for each kind of layer."""
    base_cfg, variants = _layer_variants(cfg)
    base = count(base_cfg, cell)
    flat = dict(base)
    for n, vc in variants:
        delta = _vec(lambda v, b: v - b, count(vc, cell), base)
        flat = _vec(lambda t, d: t + (n - 1) * d, flat, delta)
    return flat


def _rwkv_bilinear_cost(cfg, cell, mesh, *, opts=None, s0=16, s1=32,
                        count=None):
    """cost(L,S) = α + βL + γS + δLS fitted from 4 short runs."""
    def cc(L, S):
        c = ShapeCell(cell.name, S, cell.global_batch, cell.kind)
        return count(cfg.replace(n_layers=L), c)

    c11, c21 = cc(1, s0), cc(2, s0)
    c12, c22 = cc(1, s1), cc(2, s1)
    L, S = cfg.n_layers, cell.seq_len
    ds = s1 - s0

    def fit(k):
        a11, a21 = c11.get(k, 0.0), c21.get(k, 0.0)
        a12, a22 = c12.get(k, 0.0), c22.get(k, 0.0)
        delta = ((a22 - a12) - (a21 - a11)) / ds
        beta = (a21 - a11) - delta * s0
        gamma = (a12 - a11) / ds - delta
        alpha = a11 - beta - gamma * s0 - delta * s0
        return max(0.0, alpha + beta * L + gamma * S + delta * L * S)

    keys = set(c11) | set(c21) | set(c12) | set(c22)
    return {k: fit(k) for k in keys}


def cell_cost(cfg, cell, mesh, *, opts=None, extrapolate=False,
              device="cpu", chunk=1024):
    """(flat cost with ``temp_bytes``, how it was had)."""
    count = lambda c, k: run_step(c, k, mesh, chunk=chunk, opts=opts,
                                  device=device)
    if cfg.family == "ssm" and cell.kind != "decode":
        return (_rwkv_bilinear_cost(cfg, cell, mesh, opts=opts, count=count),
                "bilinear fit over (L, S)")
    if extrapolate:
        return (_extrapolated(count, cfg, cell, mesh, opts=opts),
                "L in {1, 2} extrapolation")
    return count(cfg, cell), "full depth"


def run_cell(arch: str, shape: str, mesh_name: str, verbose=True,
             opts=None, extrapolate=False):
    t0 = time.time()
    device = default_device()
    cfg = get_config(arch)
    cell = SHAPES[shape]
    sizes = MESHES[mesh_name]
    n_dev = math.prod(sizes.values())
    mesh = fake_mesh(sizes, device)
    flat, how = cell_cost(cfg, cell, mesh, opts=opts,
                          extrapolate=extrapolate, device=device)
    args = arg_bytes(cfg, cell, mesh, opts=opts)
    temp = int(flat.pop("temp_bytes", 0.0))
    cost = _unflatten_cost(flat)
    coll_bytes = float(sum(b for _, b in cost["coll"].values()))
    t_c = cost["flops"] / roofline.PEAK_FLOPS
    t_m = cost["bytes"] / roofline.HBM_BW
    t_x = coll_bytes / roofline.LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    mf = roofline.model_flops_for(cfg, cell)
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "ok": True,
        "compile_s": round(time.time() - t0, 1),
        "per_device_bytes": args + temp, "arg_bytes": args,
        "temp_bytes": temp, "cost_from": how,
        "flops": cost["flops"], "hbm_bytes": cost["bytes"],
        "hbm_bytes_raw": cost["bytes"],
        "coll_bytes": coll_bytes, "coll_detail": cost["coll"],
        "t_compute": t_c, "t_memory": t_m, "t_collective": t_x,
        "bottleneck": max(terms, key=terms.get),
        "model_flops": mf,
        "useful_ratio": mf / max(1.0, cost["flops"] * n_dev),
        "opts": opts or {}, "n_devices": n_dev,
        "how": ("fake process group, fake tensors on " + device
                + "; H100 SXM5 data-sheet rates, not a card measurement"),
    }
    if verbose:
        print(f"[{arch} × {shape} × {mesh_name}] OK "
              f"run={rec['compile_s']}s "
              f"mem/dev={rec['per_device_bytes'] / 2**30:.2f}GiB "
              f"t=(c {t_c * 1e3:.2f} | m {t_m * 1e3:.2f} | "
              f"x {t_x * 1e3:.2f})ms → {rec['bottleneck']} "
              f"useful={rec['useful_ratio']:.3f}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--extrapolate", action="store_true",
                    help="cost from L in {1, 2} variants, not full depth")
    ap.add_argument("--opt", action="append", default=[],
                    help="perf option key=value (zero1=true, "
                         "moe_dispatch=batched, remat_policy=dots, "
                         "ssm_scan_dtype=bfloat16, shard_cache_seq=true)")
    args = ap.parse_args(argv)

    opts = {}
    for o in args.opt:
        k, v = o.split("=", 1)
        opts[k] = {"true": True, "false": False}.get(v, v)
    _set_opts(opts)          # an option the port cannot honour raises here

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([args.shape] if args.shape else applicable_shapes(cfg))
        for shape in shapes:
            for mesh_name in meshes:
                key = f"{arch}_{shape}_{mesh_name}"
                try:
                    rec = run_cell(arch, shape, mesh_name, opts=opts,
                                   extrapolate=args.extrapolate)
                except Exception as e:   # noqa: BLE001 — record and continue
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "ok": False, "error": f"{type(e).__name__}: {e}"}
                    failures.append(key)
                with open(os.path.join(args.out, key + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("dry-run complete: every cell ran")


if __name__ == "__main__":
    main()
