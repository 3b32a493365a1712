"""Driver of partitioned GCN training cells: one call of the program's own
entry, ``repro_torch.apps.gnn.train_gnn(partitions=P,
partition_strategy=..., overlap=...)``, in each of P ranks that the
driver starts itself, a card per rank over NCCL.

The traffic file gives ``partitions``, ``partition_strategy`` and
``overlap`` besides the graph.  The driver loads (or generates) the graph
and builds the program's kernels once, then starts the P ranks as
processes of this file (``--rank``).  Each rank joins the process group
through a TCP store on ``localhost`` with a set-up timeout of its own, so a
fault exits non-zero and does not hang; the driver kills the others when
one fails and gives up after a deadline.  Each rank draws the whole task's
inputs and initial weights on its card from ``--seed`` (the ranks check
that they drew the same bits) and trains its shard.

Rank 0 times every step through ``on_step``, reads the loop's ``params``
and ``opt`` as ``drivers/train_gnn.py`` does (the parameters are
replicated, the gradients summed over the ranks), and after the window
runs the plain reference (``reference/gnn.py``, on one card) and its
comparison.  ``setup_s`` runs from the driver's start to the end of rank
0's step 0; ``peak_mem_gib`` is the largest of the ranks'.  ``--trace 1``
reads the per-layer metrics from rank 0: its spans, its card's profiled
steps (``drivers/train_gnn.py``'s windows) and its shard's work count.

    python3 perfbench/run.py --workload gcn.train.part4 --seed 1 \\
        --seconds 10 --trace 0

runs a cell that ``BENCHMARK.json`` declares.  ``gcn.train.part4``'s
traffic (``traffic/part4.json``), limits (``cells/gcn.train.part4.json``)
and readers (``metrics/part4_*.py``) are here, but the file does not
declare the cell: its ``step_ms`` spread 18.5–20% between runs on four
H100s, over the 12.5% a cell is admitted with, the step being bound by
the host (a third of rank 0's step leaves its card idle).

``run(..., backend="gloo")`` runs the same ranks over gloo: on the CPU,
or sharing one card (the collectives staged through the host), where the
cell's limits were set.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import runpy
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

SETUP_TIMEOUT_S = 180      # process group set-up and its first collective
DEADLINE_S = 1200          # the whole run, past which the ranks are killed


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, backend=None, plant=None):
    """One run of ``cell``: returns ``(result, checks)``.  ``plant``: a
    Python file each rank runs before it trains (the tests plant faults
    in the program with it)."""
    import torch

    from perfbench import bench
    device = torch.device(device or "cuda")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    world = int(cell.traffic["partitions"])
    bench.load_graph(cell)               # once, before the ranks load it
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build()                    # the ranks load, not compile
    with tempfile.TemporaryDirectory(prefix="perfbench_part_") as tmp:
        init = f"tcp://127.0.0.1:{_free_port()}"
        args = [sys.executable, str(Path(__file__).resolve()),
                "--root", str(cell.root), "--workload", cell.name,
                "--seed", str(seed), "--seconds", str(seconds),
                "--trace", str(int(trace)), "--t-start", repr(t_start),
                "--device", device.type, "--backend", backend,
                "--init", init, "--world", str(world), "--out", tmp]
        if plant:
            args += ["--plant", str(plant)]
        # the ranks import what this process imports
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in sys.path if p and os.path.isdir(p)))
        procs = [subprocess.Popen(args + ["--rank", str(r)], env=env)
                 for r in range(world)]
        _wait(procs, DEADLINE_S)
        with open(os.path.join(tmp, "result.json")) as f:
            out = json.load(f)
    return out["result"], out["checks"]


def _wait(procs, deadline_s: float) -> None:
    """Wait for every rank; on a rank's failure or past the deadline kill
    the rest and raise."""
    end = time.monotonic() + deadline_s
    while True:
        codes = [p.poll() for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        late = time.monotonic() > end
        if bad or late:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            raise RuntimeError(f"rank(s) failed: {bad}" if bad else
                               f"ranks still running after {deadline_s} s")
        if all(c == 0 for c in codes):
            return
        time.sleep(0.05)


def _rank_main(a) -> None:
    """One rank: join the group, draw the inputs, train this shard; rank 0
    also judges the run and writes it to ``<out>/result.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from perfbench import bench
    from repro_torch.apps.gnn import train_gnn
    from repro_torch.core.sparse import CSRMatrix
    from repro_torch.data.tasks import NodeTask

    if a.plant:
        runpy.run_path(a.plant)
    cell = bench.load_cell(a.workload, Path(a.root))
    base = bench.load_module("drivers", "train_gnn", cell.root)
    cuda = a.device == "cuda"
    # the host's cores split between the ranks, as comm.spawn splits them
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // a.world))
    if cuda:
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", a.rank if a.backend == "nccl"
                           else a.rank % n_cards)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(a.backend, init_method=a.init, rank=a.rank,
                            world_size=a.world,
                            timeout=timedelta(seconds=SETUP_TIMEOUT_S))
    try:
        cfg, traffic = cell.config, cell.traffic
        indptr, indices, n = bench.load_graph(cell)
        X, labels, train, val, params0 = base.make_inputs(cell, n, a.seed,
                                                          dev)
        sums = [float(t.double().sum()) for t in
                (X, labels, train, *(v for p in params0 for v in p.values()))]
        every = [None] * a.world
        dist.all_gather_object(every, (sums, str(dev)))
        if any(s != every[0][0] for s, _ in every):
            raise RuntimeError("the ranks drew different inputs from the "
                               "same seed")
        task = NodeTask(csr=CSRMatrix(indptr, indices,
                                      np.ones(indices.shape[0], np.float32),
                                      n, n),
                        features=X, labels=labels, train_mask=train,
                        val_mask=val, n_classes=cfg["dims"][-1])
        total = 1 + base.window_steps(cell, a.seconds)
        clock = base.StepClock(total, cfg["adamw"]["b1"],
                               a.trace and cuda and a.rank == 0)
        spans = []
        obs_ctx = base._obs_tracing() if a.trace and a.rank == 0 else None
        try:
            res = train_gnn(task, model=cfg["model"], hidden=cfg["dims"][1],
                            n_layers=len(cfg["dims"]) - 1, steps=total,
                            lr=cfg["adamw"]["lr"],
                            fused=cfg.get("fused", True), partitions=a.world,
                            partition_strategy=traffic["partition_strategy"],
                            overlap=traffic["overlap"],
                            params=[{k: v.clone() for k, v in p.items()}
                                    for p in params0],
                            device=dev, on_step=clock)
        finally:
            if obs_ctx is not None:
                spans = obs_ctx.stop()
        peaks = [None] * a.world
        dist.all_gather_object(peaks, clock.peak if cuda else 0)
        if a.rank == 0:
            out = _judge(cell, base, a, res, clock, spans, peaks, every,
                         (indptr, indices, n), (X, labels, train, params0),
                         dev)
            tmp = os.path.join(a.out, "result.tmp")
            with open(tmp, "w") as f:
                json.dump(out, f)
            os.replace(tmp, os.path.join(a.out, "result.json"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _judge(cell, base, a, res, clock, spans, peaks, every, graph, inputs,
           dev):
    """Rank 0's result line and checks."""
    import torch

    from perfbench import bench
    indptr, indices, n = graph
    X, labels, train, params0 = inputs
    total = len(clock.t)
    t = clock.t
    steps = [b - s for s, b in zip(t[:total - 1], t[1:])]
    peak = max(peaks)
    losses = res.losses
    cuda = dev.type == "cuda"
    devices = sorted({d for _, d in every})
    result = {"correct": False, "attempted": total - 1,
              "failed": sum(not math.isfinite(x) for x in losses[1:]),
              "metrics": {},
              "device": ({"platform": "gpu",
                          "kind": torch.cuda.get_device_name(dev),
                          "count": len(devices), "memory_peak_bytes": peak}
                         if cuda else {"platform": "cpu", "kind": "cpu",
                                       "count": 0, "memory_peak_bytes": 0})}
    metrics = {"setup_s": t[0] - a.t_start,
               "step_ms": (t[-1] - t[0]) / (total - 1) * 1e3,
               "peak_mem_gib": peak / 2 ** 30}
    sys.stderr.write(
        f"[run] {cell.name} seed {a.seed}: {a.world} ranks over "
        f"{a.backend} on {devices}, {total - 1} window steps, configs "
        f"{[c.astuple() for c in res.config]}, val_acc {res.val_acc:.4f}, "
        f"losses {losses[0]:.6f} -> {losses[-1]:.6f}, peaks by rank "
        f"{[round(p / 2 ** 30, 4) for p in peaks]} GiB, step ms median "
        f"{bench.nearest_rank(steps, 0.5) * 1e3:.4g} p95 "
        f"{bench.nearest_rank(steps, 0.95) * 1e3:.4g} max "
        f"{max(steps) * 1e3:.4g}, "
        + ", ".join(f"{k} {v:.6g}" for k, v in metrics.items()) + "\n")
    del res
    if cuda:
        torch.cuda.empty_cache()
    reference = bench.load_module("reference", cell.config["reference"],
                                  cell.root)
    adj = reference.Adjacency(indptr, indices, n, dev)
    ref = reference.train(cell.config, params0, X, labels.long(), train, adj,
                          3)
    gaps = base.compare(params0, losses, clock.first_grad,
                        clock.params_after_3, ref)
    limits = cell.spec["limits"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    checks["bad_losses"] = {"value": sum(not math.isfinite(x)
                                         for x in losses), "limit": 0}
    if not a.trace:
        result["metrics"] = {m["name"]: {"value": metrics[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        ctx = _trace_context(cell, a, clock, steps, spans, graph, dev)
        for m in cell.per_layer:
            v = bench.load_module("metrics", m["name"], cell.root).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        if ctx.prof is not None:
            result["device"]["busy_s"] = ctx.prof.busy_s
            result["device"]["window_s"] = ctx.prof.window_s
            result["breakdown"] = {
                "device_ops": ctx.prof.top_ops(),
                "idle_gaps": ctx.labels.idle_gaps() if ctx.labels else []}
    result["correct"] = bench.judge(checks)
    return {"result": result, "checks": checks}


def _trace_context(cell, a, clock, steps, spans, graph, dev):
    """What the per-layer metric readers read, from rank 0: its card's
    profiled and labelled steps, its spans, its steps before CUPTI
    started, and the work of its shard (``work.py``'s count at the
    shard's rows and nonzeros of Â: its halo rows' reads are left out,
    so the least time is a lower bound)."""
    import numpy as np

    from perfbench import devtrace, work
    from repro_torch.core.sparse import CSRMatrix
    from repro_torch.dist.partition import partition_csr
    prof = labels = None
    if clock.events:
        a0, a1 = clock.metric_steps
        prof = devtrace.DeviceWindow.from_events(clock.events[a0], a1 - a0)
        b0, b1 = clock.label_steps
        labels = devtrace.DeviceWindow.from_events(clock.events[b0], b1 - b0)
    plain = clock.unprofiled(steps)
    indptr, indices, n = graph
    a_hat = CSRMatrix(indptr, indices, np.ones(indices.shape[0], np.float32),
                      n, n).gcn_normalize()
    shard = partition_csr(a_hat, a.world,
                          cell.traffic["partition_strategy"]).shards[a.rank]
    rows, nnz = shard.stop - shard.start, shard.csr.nnz
    return SimpleNamespace(cell=cell, config=cell.config, n=rows, nnz=nnz,
                           ops=work.step_ops(cell.config, rows, nnz),
                           prof=prof, labels=labels, spans=spans,
                           steps_s=plain, step_s=sum(plain) / len(plain),
                           device=dev, world=a.world, backend=a.backend)


def _args(argv=None):
    ap = argparse.ArgumentParser(description="one rank of a partitioned "
                                 "training cell")
    for k in ("--root", "--workload", "--device", "--backend", "--init",
              "--out"):
        ap.add_argument(k, required=True)
    for k in ("--seed", "--trace", "--world", "--rank"):
        ap.add_argument(k, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--t-start", type=float, required=True)
    ap.add_argument("--plant")
    return ap.parse_args(argv)


if __name__ == "__main__":
    _rank_main(_args())
