"""Driver of the published GAT's training cells (``configs/gatppi.json``):
one call of the program's own entry, ``repro_torch.apps.gnn.train_gnn``
with ``attention="additive"``, per run.

It is ``drivers/train_gnn.py``'s run, with that file's step clock, loop
state and comparison (imported from it, not copied), for a multi-label
task: per node the configuration's ``dims[0]`` N(0, 1) features and
``dims[-1]`` Bernoulli(0.5) labels, a train mask of the traffic's
``train_frac``, drawn on the device from ``--seed`` with the initial
weights (He-normal ``w``, ``al``, ``ar``; zero biases).  ``correct``
compares the call's first three steps with the plain reference
(``reference/gat_ppi.py``) from the same inputs: ``loss_gap``,
``grad_gap`` (weights and biases), ``grad_gap_att`` (attention vectors),
``change_gap`` and ``bad_losses`` (``compare``).  ``--trace 1`` profiles
a stretch of steady steps for the per-layer metrics, whose work counts
come from ``work_gat.py``, and prints the kernel launches by family.

A program whose ``train_gnn`` has no additive attention is refused
before the graph is loaded.
"""
from __future__ import annotations

import inspect
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from perfbench import bench, devtrace, work_gat

NEEDS = ("attention",)


def _base(cell):
    return bench.load_module("drivers", "train_gnn", cell.root)


def init_params(config, gen, device):
    """He-initialised ``w`` (d_in × H·F′), ``al`` and ``ar`` (H × F′, over
    fan-in F′) and zero biases, drawn from ``gen`` in one call."""
    dims = config["dims"]
    hd = work_gat.head_dims(dims, config["heads"])
    shapes = [[("w", (dims[i], H * F), dims[i]), ("al", (H, F), F),
               ("ar", (H, F), F)] for i, (H, F) in enumerate(hd)]
    flat = torch.randn(sum(a * b for layer in shapes for _, (a, b), _ in
                           layer), generator=gen, device=device)
    params, at = [], 0
    for layer, d_out in zip(shapes, dims[1:]):
        p = {}
        for k, (a, b), fan_in in layer:
            p[k] = flat[at:at + a * b].view(a, b) * math.sqrt(2.0 / fan_in)
            at += a * b
        p["b"] = torch.zeros(d_out, device=device)
        params.append(p)
    return params


def make_inputs(cell, n: int, seed: int, device):
    """Features N(0, 1), multi-hot labels Bernoulli(0.5), a train mask of
    ``train_frac`` of the nodes (the rest validate) and the initial
    weights, all from one generator on ``device`` seeded with ``seed``."""
    dims = cell.config["dims"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    X = torch.randn((n, dims[0]), generator=gen, device=device)
    labels = (torch.rand((n, dims[-1]), generator=gen, device=device)
              < 0.5).float()
    order = torch.randperm(n, generator=gen, device=device)
    train = torch.zeros(n, device=device)
    train[order[:int(cell.traffic["train_frac"] * n)]] = 1.0
    params = init_params(cell.config, gen, device)
    return X, labels, train, 1.0 - train, params


def compare(p0, losses, grads, after3, ref, detail=False):
    """``drivers/train_gnn.py::compare``'s numbers, with ``grad_gap``
    split: ``grad_gap`` is the worst of the weights' and biases' leaves,
    ``grad_gap_att`` the worst of the attention vectors' (``al``, ``ar``),
    each leaf's gap as that file reads it.  An attention vector's
    gradient sums ``de`` over every edge and node, and on some seeds that
    sum cancels far enough that float32 rounding alone moves it by
    tenths of the control's gap, so it is held against the planted faults
    and the other leaves against the TF32 control."""
    base = bench.load_module("drivers", "train_gnn",
                             Path(__file__).resolve().parents[1])
    out = base.compare(p0, losses, grads, after3, ref, detail=True)
    gaps = base.leaf_gaps(out["grad_leaves"])
    att = {k for k in gaps if k.rsplit(".", 1)[1] in ("al", "ar")}
    out["grad_gap"] = max(v for k, v in gaps.items() if k not in att)
    out["grad_gap_att"] = max(gaps[k] for k in att)
    if not detail:
        for k in ("grad_leaves", "change_leaves", "losses", "ref_losses"):
            del out[k]
    return out


def check_program(train_gnn) -> None:
    """Raise at once unless ``train_gnn`` takes the additive GAT's
    options."""
    missing = [k for k in NEEDS
               if k not in inspect.signature(train_gnn).parameters]
    if missing:
        raise RuntimeError(f"this program's train_gnn has no {missing}: it "
                           "cannot train the additive GAT")


def train_program(cell, task, params0, steps, device, on_step):
    """The program's call: ``steps`` steps of the configuration."""
    from repro_torch.apps.gnn import train_gnn
    cfg = cell.config
    return train_gnn(task, model="gat", attention="additive",
                     heads=list(cfg["heads"]), hidden=cfg["dims"][1],
                     n_layers=len(cfg["dims"]) - 1, steps=steps,
                     lr=cfg["adamw"]["lr"],
                     params=[{k: v.clone() for k, v in layer.items()}
                             for layer in params0],
                     device=device, on_step=on_step)


def counters(reset=False):
    """Kernel launches by family (the wrappers' counters), the slot pass
    of the GAT backward included."""
    from repro_torch.kernels.paramspmm import ops as spmm_ops
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    if reset:
        spmm_ops.reset_launch_count()
        sddmm_ops.reset_launch_count()
    out = {"paramspmm": spmm_ops.launch_count()}
    for name in ("sddmm_softmax", "sddmm", "gat_backward"):
        try:
            out[name] = sddmm_ops.launch_count(name)
        except KeyError:               # a program without that kernel
            pass
    return out


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device=None):
    """One run of ``cell``: returns ``(result, checks)``."""
    import numpy as np

    from repro_torch.apps.gnn import train_gnn
    from repro_torch.core.sparse import CSRMatrix
    from repro_torch.data.tasks import NodeTask

    check_program(train_gnn)
    base = _base(cell)
    reference = bench.load_module("reference", cell.config["reference"],
                                  cell.root)
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cfg = cell.config
    t_begin = time.perf_counter()
    indptr, indices, n = bench.load_graph(cell)
    t_graph = time.perf_counter()
    X, labels, train, val, params0 = make_inputs(cell, n, seed, device)
    task = NodeTask(csr=CSRMatrix(indptr, indices,
                                  np.ones(indices.shape[0], np.float32),
                                  n, n),
                    features=X, labels=labels, train_mask=train,
                    val_mask=val, n_classes=cfg["dims"][-1])
    total = 1 + base.window_steps(cell, seconds)
    clock = base.StepClock(total, cfg["adamw"]["b1"], trace and cuda)
    spans = []
    counters(reset=True)
    obs_ctx = base._obs_tracing() if trace else None
    t_call = time.perf_counter()
    try:
        res = train_program(cell, task, params0, total, device, clock)
    finally:
        if obs_ctx is not None:
            spans = obs_ctx.stop()
    launches = counters()
    t = clock.t
    steps = [b - a for a, b in zip(t[:total - 1], t[1:])]
    peak = clock.peak if cuda else 0
    losses = res.losses
    failed = sum(not math.isfinite(x) for x in losses[1:])
    result = {"correct": False, "attempted": total - 1, "failed": failed,
              "metrics": {}, "device": base._device(cell, device, peak)}
    metrics = {
        "setup_s": t[0] - t_start,
        "step_ms": (t[-1] - t[0]) / (total - 1) * 1e3,
        "peak_mem_gib": peak / 2 ** 30,
    }
    sys.stderr.write(
        f"[setup] imports {t_begin - t_start:.3f} s, graph "
        f"{t_graph - t_begin:.3f} s, inputs {t_call - t_graph:.3f} s, "
        f"pack and step 0 {t[0] - t_call:.3f} s\n")
    sys.stderr.write(
        f"[run] {cell.name} seed {seed}: {total - 1} window steps, "
        f"config {res.config.astuple()}, val label accuracy "
        f"{res.val_acc:.4f}, losses {losses[0]:.6f} -> {losses[-1]:.6f}, "
        + ", ".join(f"{k} {v:.6g}" for k, v in metrics.items()) + "\n")
    del res, task
    if cuda:
        torch.cuda.empty_cache()

    # the reference, after the window, from the same inputs
    adj = reference.Adjacency(indptr, indices, n, device)
    ref = reference.train(cfg, params0, X, labels, train, adj, 3)
    gaps = compare(params0, losses, clock.first_grad, clock.params_after_3,
                   ref)
    limits = cell.spec["limits"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    checks["bad_losses"] = {"value": sum(not math.isfinite(x)
                                         for x in losses), "limit": 0}

    if not trace:
        result["metrics"] = {m["name"]: {"value": metrics[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        ctx = trace_context(cell, clock, steps, spans, adj, n, device,
                            launches)
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
    return result, checks


def trace_context(cell, clock, steps, spans, adj, n, device, launches):
    """What the per-layer metric readers read, with this configuration's
    work count."""
    prof = labels = None
    if clock.events:
        a0, a1 = clock.metric_steps
        prof = devtrace.DeviceWindow.from_events(clock.events[a0], a1 - a0)
        b0, b1 = clock.label_steps
        labels = devtrace.DeviceWindow.from_events(clock.events[b0], b1 - b0)
    plain = clock.unprofiled(steps)
    ops = work_gat.step_ops(cell.config, n, adj.nnz)
    sys.stderr.write(f"[trace] launches over {len(steps)} window steps, "
                     f"step 0 and the evaluation: {launches}; the model's "
                     f"structure gives {base_launches(ops)} a step\n")
    return SimpleNamespace(cell=cell, config=cell.config, n=n, nnz=adj.nnz,
                           ops=ops, prof=prof, labels=labels, spans=spans,
                           steps_s=plain, step_s=sum(plain) / len(plain),
                           adj=adj, device=device, launches=launches)


def base_launches(ops) -> dict:
    """Launches a step by family: one an op, and the slot pass once a
    layer."""
    from perfbench import work
    out = work.launches(ops)
    out["gat_backward"] = out.get("sddmm", 0)
    return out
