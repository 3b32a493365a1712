"""Readings that a training cell's limits are set from, in one process on
the card (the benchmark's runs never run this):

    python3 perfbench/calibrate.py --workload gcn.train.rmat18 \\
        --seeds 11,12,...,22 --control-seeds 11,12,13 --out FILE.json

For each ``--seeds`` seed the program's first three steps through
``train_gnn`` (as a run drives them) against the float32 reference: the
lower readings.  For each ``--control-seeds`` seed, in the program's
place against the same reference: the reference with TF32 matmuls (the
control: the precision below float32 with TF32 off) and the reference
with a planted fault (half of the train nodes left out of the loss, its
mean taken over the rest; a block of 1/64 of the rows of every
aggregation left unwritten, at zero).  A step that leaves the state
unchanged reads 1 by ``change_gap`` and needs no run.  The program's pack
is built once and reused across seeds: it depends on the graph alone.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def _short(r):
    return {k: r[k] for k in NUMBERS}


def _first_only(fn):
    """``fn`` called once; later calls return the first result."""
    memo = []

    def wrapped(*a, **kw):
        if not memo:
            memo.append(fn(*a, **kw))
        return memo[0]
    return wrapped


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT / "perfbench"),
                    help="the benchmark's folder (a copy, for a rehearsal)")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import numpy as np
    import torch

    from perfbench import bench
    from repro_torch.apps import gnn as app
    from repro_torch.core.sparse import CSRMatrix

    root = Path(args.root)
    cell = bench.load_cell(args.workload, root)
    drv = bench.load_module("drivers", cell.traffic["driver"], root)
    ref_mod = bench.load_module("reference", cell.config["reference"], root)
    device = torch.device(args.device)
    indptr, indices, n = bench.load_graph(cell)
    csr = CSRMatrix(indptr, indices, np.ones(indices.shape[0], np.float32),
                    n, n)
    adj = ref_mod.Adjacency(indptr, indices, n, device)
    build_spmm = app.build_spmm
    app.build_spmm = _first_only(build_spmm)
    try:
        out = _readings(args, cell, drv, ref_mod, app, csr, adj, n, device)
    finally:
        app.build_spmm = build_spmm
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    for what in ("program", "control", "half_batch", "block_lost"):
        rows = out[what].values()
        if rows:
            agg = max if what == "program" else min
            print(f"{what}: " + ", ".join(
                f"{k} {agg(r[k] for r in rows):.4g}"
                for k in NUMBERS),
                "(largest)" if what == "program" else "(smallest)")


def _readings(args, cell, drv, ref_mod, app, csr, adj, n, device):
    import torch

    from repro_torch.data.tasks import NodeTask
    cfg = cell.config
    out = {"cell": cell.name, "device": (torch.cuda.get_device_name(0)
                                         if device.type == "cuda" else "cpu"),
           "program": {}, "control": {}, "half_batch": {}, "block_lost": {}}

    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        X, labels, train, val, p0 = drv.make_inputs(cell, n, seed, device)
        task = NodeTask(csr=csr, features=X, labels=labels, train_mask=train,
                        val_mask=val, n_classes=cfg["dims"][-1])
        clock = drv.StepClock(3, cfg["adamw"]["b1"], False)
        res = app.train_gnn(task, model=cfg["model"], hidden=cfg["dims"][1],
                            n_layers=len(cfg["dims"]) - 1, steps=3,
                            lr=cfg["adamw"]["lr"], heads=cfg.get("heads", 1),
                            fused=cfg.get("fused", True),
                            params=[{k: v.clone() for k, v in l.items()}
                                    for l in p0],
                            device=device, on_step=clock)
        losses = res.losses
        del res, task
        ref = ref_mod.train(cfg, p0, X, labels, train, adj, 3)
        r = drv.compare(p0, losses, clock.first_grad,
                        clock.params_after_3, ref, detail=True)
        out["program"][seed] = r
        print(f"program seed {seed}: {_short(r)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def block_lost(x):
        keep = torch.ones(x.shape[0], device=x.device)
        keep[:max(1, x.shape[0] // 64)] = 0.0
        return x * keep.view(-1, *([1] * (x.dim() - 1)))

    for seed in [int(s) for s in args.control_seeds.split(",")]:
        X, labels, train, _, p0 = drv.make_inputs(cell, n, seed, device)
        base = ref_mod.train(cfg, p0, X, labels, train, adj, 3)
        odd = torch.zeros_like(train)
        odd[torch.nonzero(train)[1::2, 0]] = 1.0     # half the train nodes

        def half_loss(logits, lab, mask, odd=odd):
            return ref_mod.node_loss(logits, lab, mask * (1.0 - odd))

        for what, kw in (("control", {"use_tf32": True}),
                         ("half_batch", {"loss_fn": half_loss}),
                         ("block_lost", {"fault": block_lost})):
            other = ref_mod.train(cfg, p0, X, labels, train, adj, 3, **kw)
            r = drv.compare(p0, other[0], other[1], other[2], base,
                            detail=True)
            out[what][seed] = r
            print(f"{what} seed {seed}: {_short(r)}", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
