"""Driver of full-batch GNN training cells: one call of the program's own
entry, ``repro_torch.apps.gnn.train_gnn``, per run.

Set-up: the graph (from the cache), the inputs and initial weights drawn
on the device from ``--seed``, then the call itself: its pack (span
``gnn.pack``) and step 0, which builds or loads the kernels.  The window
is the call's steps after step 0, each step's end timed through
``on_step``.  The comparison that decides ``correct`` follows the same
call: the losses of its first three steps, the first gradient as the
optimizer got it (its first moment after step 0 over 1 − β1) and the
parameters after step 2, read from the loop's state when ``on_step`` is
called, against the plain reference (``reference/gnn.py``) from the same
inputs.  ``--trace 1`` profiles a stretch of steady steps for the
per-layer metrics.
"""
from __future__ import annotations

import math
import statistics
import sys
import time
from types import SimpleNamespace

import torch

from perfbench import bench, devtrace, work

PROFILED = 20        # steady steps in the traced run's metric window
LABELLED = 5         # steps profiled with the host for the idle gaps


def window_steps(cell, seconds: float) -> int:
    """Steps after step 0: ``seconds`` at the cell's nominal step time."""
    return max(1, round(seconds * 1e3 / cell.spec["nominal_step_ms"]))


def init_params(config, gen, device):
    """He-initialised weights and zero biases, drawn from ``gen`` in one
    call: GCN ``w, b`` per layer; GAT ``wq, wk, wv, b`` per layer."""
    dims, L = config["dims"], len(config["dims"]) - 1
    shapes = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        if config["model"] == "gcn":
            shapes.append([("w", (d_in, d_out))])
        else:
            H = config.get("heads", 1)
            dv = d_out // H if (H > 1 and i < L - 1) else d_out
            shapes.append([("wq", (d_in, H * dv)), ("wk", (d_in, H * dv)),
                           ("wv", (d_in, H * dv))])
    flat = torch.randn(sum(a * b for layer in shapes for _, (a, b) in layer),
                       generator=gen, device=device)
    params, at = [], 0
    for layer, d_out in zip(shapes, dims[1:]):
        p = {}
        for k, (a, b) in layer:
            p[k] = flat[at:at + a * b].view(a, b) * math.sqrt(2.0 / a)
            at += a * b
        p["b"] = torch.zeros(d_out, device=device)
        params.append(p)
    return params


def make_inputs(cell, n: int, seed: int, device):
    """Features N(0, 1), labels uniform over the classes, a train mask of
    ``train_frac`` of the nodes (the rest validate) and the initial
    weights, all from one generator on ``device`` seeded with ``seed``."""
    dims = cell.config["dims"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    X = torch.randn((n, dims[0]), generator=gen, device=device)
    labels = torch.randint(0, dims[-1], (n,), generator=gen, device=device)
    order = torch.randperm(n, generator=gen, device=device)
    train = torch.zeros(n, device=device)
    train[order[:int(cell.traffic["train_frac"] * n)]] = 1.0
    params = init_params(cell.config, gen, device)
    return X, labels, train, 1.0 - train, params


def _loop_state():
    """The calling loop's ``params`` and ``opt`` (``train_gnn``'s locals
    when it calls ``on_step``)."""
    f = sys._getframe(2)
    for _ in range(4):
        if f is None:
            break
        loc = f.f_locals
        if "params" in loc and "opt" in loc:
            return loc["params"], loc["opt"]
        f = f.f_back
    raise RuntimeError("on_step was not called from a loop holding "
                       "`params` and `opt`: the optimizer's state cannot "
                       "be read")


def _copy(tree):
    return [{k: v.detach().clone() for k, v in layer.items()}
            for layer in tree]


class StepClock:
    """``on_step``: the time at each step's end; the optimizer's first
    moment after step 0 and the parameters after step 2; the device's
    peak memory at the window's end; the profiler windows of a traced
    run, at the window's end: once CUPTI has started, every later launch
    costs more, so the steps before it are the traced run's unprofiled
    ones."""

    def __init__(self, total: int, b1: float, profile: bool):
        self.t = [0.0] * total
        self.b1 = b1
        self.peak = 0
        self.first_grad = self.params_after_3 = None
        self.windows = []
        if profile:
            from torch.profiler import ProfilerActivity as A
            a0 = max(3, total - PROFILED - LABELLED - 8)
            self.metric_steps = (a0, a0 + PROFILED)
            b0 = a0 + PROFILED + 3
            self.label_steps = (b0, b0 + LABELLED)
            self.windows = [(a0, a0 + PROFILED, [A.CUDA]),
                            (b0, b0 + LABELLED, [A.CPU, A.CUDA])]
        self.profilers, self.events = {}, {}

    def __call__(self, step: int):
        self.t[step] = time.perf_counter()
        if step == 0:
            _, opt = _loop_state()
            self.first_grad = [{k: v.detach() / (1.0 - self.b1)
                                for k, v in layer.items()}
                               for layer in _copy(opt["m"])]
        elif step == 2:
            self.params_after_3 = _copy(_loop_state()[0])
        if step == len(self.t) - 1 and torch.cuda.is_available():
            self.peak = torch.cuda.max_memory_allocated()
        for start, stop, acts in self.windows:
            if step == start - 1:          # profile steps start..stop-1
                from torch.profiler import ProfilerActivity, profile
                if start == self.windows[0][0]:
                    # CUPTI's start-up, outside the profiled steps
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]):
                        torch.ones(1, device="cuda").add_(1)
                        torch.cuda.synchronize()
                self.profilers[start] = p = profile(activities=acts)
                p.start()
            elif step == stop - 1:
                # read the trace at once: a later profiler's start clears
                # what this one kept
                self.profilers[start].stop()
                self.events[start] = devtrace.chrome_events(
                    self.profilers.pop(start))

    def unprofiled(self, steps: list) -> list:
        """The step times (``steps[i - 1]`` is step i) before the first
        profiler started."""
        return steps[:self.windows[0][0] - 1] if self.windows else steps


def leaf_norms(prog, ref):
    """``{"<layer>.<key>": (‖prog leaf‖, ‖ref leaf‖)}``."""
    return {f"{i}.{k}": (float(prog[i][k].norm()), float(v.norm()))
            for i, layer in enumerate(ref) for k, v in layer.items()}


def leaf_gaps(norms, skip=()):
    """Each leaf's |‖prog‖ − ‖ref‖| over the larger of its reference norm
    and the median leaf's; ``skip`` leaves left out."""
    kept = {k: v for k, v in norms.items() if k not in skip}
    med = statistics.median(r for _, r in kept.values())
    return {k: abs(p - r) / max(r, med) for k, (p, r) in kept.items()}


def compare(p0, losses, grads, after3, ref, detail=False):
    """The compared numbers of a run: program (losses of steps 0–2, the
    first gradient, the parameters after step 2) against the reference's
    ``(losses, first gradient, parameters after 3 steps)``.  With
    ``detail``, also each leaf's norms."""
    r_losses, r_grad, r_after = ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses[:3], r_losses))
    g = leaf_norms(grads, r_grad)
    med = statistics.median(r for _, r in g.values())
    # leaves with a gradient nought to rounding in the reference move by
    # round-off alone under Adam
    quiet = {k for k, (_, r) in g.items() if r < 1e-3 * med}
    delta = lambda after: [{k: after[i][k].float() - p0[i][k].float()
                            for k in layer} for i, layer in enumerate(p0)]
    c = leaf_norms(delta(after3), delta(r_after))
    out = {"loss_gap": loss_gap, "grad_gap": max(leaf_gaps(g).values()),
           "change_gap": max(leaf_gaps(c, quiet).values())}
    if detail:
        out["grad_leaves"], out["change_leaves"] = g, c
        out["losses"], out["ref_losses"] = list(losses[:3]), list(r_losses)
    return out


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device=None):
    """One run of ``cell``: returns ``(result, checks)``."""
    import numpy as np

    from repro_torch.apps.gnn import train_gnn
    from repro_torch.core.sparse import CSRMatrix
    from repro_torch.data.tasks import NodeTask

    reference = bench.load_module("reference", cell.config["reference"],
                                  cell.root)
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cfg = cell.config
    dims = cfg["dims"]
    if dims[1:-1] != [dims[1]] * (len(dims) - 2):
        raise ValueError(f"train_gnn takes one hidden width, not {dims}")
    t_begin = time.perf_counter()
    indptr, indices, n = bench.load_graph(cell)
    t_graph = time.perf_counter()
    X, labels, train, val, params0 = make_inputs(cell, n, seed, device)
    task = NodeTask(csr=CSRMatrix(indptr, indices,
                                  np.ones(indices.shape[0], np.float32),
                                  n, n),
                    features=X, labels=labels, train_mask=train,
                    val_mask=val, n_classes=cfg["dims"][-1])
    total = 1 + window_steps(cell, seconds)
    clock = StepClock(total, cfg["adamw"]["b1"], trace and cuda)
    spans = []
    launches = _counters(reset=True)
    obs_ctx = _obs_tracing() if trace else None
    t_call = time.perf_counter()
    try:
        res = train_gnn(task, model=cfg["model"], hidden=cfg["dims"][1],
                        n_layers=len(cfg["dims"]) - 1, steps=total,
                        lr=cfg["adamw"]["lr"], heads=cfg.get("heads", 1),
                        fused=cfg.get("fused", True),
                        params=[{k: v.clone() for k, v in layer.items()}
                                for layer in params0],
                        device=device, on_step=clock)
    finally:
        if obs_ctx is not None:
            spans = obs_ctx.stop()
    launches = _counters()
    t = clock.t
    steps = [b - a for a, b in zip(t[:total - 1], t[1:])]
    peak = clock.peak if cuda else 0
    losses = res.losses
    failed = sum(not math.isfinite(x) for x in losses[1:])
    result = {"correct": False, "attempted": total - 1, "failed": failed,
              "metrics": {}, "device": _device(cell, device, peak)}
    metrics = {
        "setup_s": t[0] - t_start,
        "step_ms": (t[-1] - t[0]) / (total - 1) * 1e3,
        "step_p95_ms": bench.nearest_rank(steps, 0.95) * 1e3,
        "peak_mem_gib": peak / 2 ** 30,
    }
    sys.stderr.write(
        f"[setup] imports {t_begin - t_start:.3f} s, graph "
        f"{t_graph - t_begin:.3f} s, inputs {t_call - t_graph:.3f} s, "
        f"pack and step 0 {t[0] - t_call:.3f} s\n")
    sys.stderr.write(
        f"[run] {cell.name} seed {seed}: {total - 1} window steps, "
        f"config {res.config.astuple()}, val_acc {res.val_acc:.4f}, "
        f"losses {losses[0]:.6f} -> {losses[-1]:.6f}, "
        + ", ".join(f"{k} {v:.6g}" for k, v in metrics.items()) + "\n")
    del res, task
    if cuda:
        torch.cuda.empty_cache()

    # the reference, after the window, from the same inputs
    adj = reference.Adjacency(indptr, indices, n, device)
    ref = reference.train(cfg, params0, X, labels.long(), train, adj, 3)
    gaps = compare(params0, losses, clock.first_grad,
                   clock.params_after_3, ref)
    limits = cell.spec["limits"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    checks["bad_losses"] = {"value": sum(not math.isfinite(x)
                                         for x in losses), "limit": 0}

    if not trace:
        result["metrics"] = {m["name"]: {"value": metrics[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        ctx = _trace_context(cell, clock, steps, spans, adj, n, device,
                             launches)
        result["metrics"] = {}
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


def _counters(reset=False):
    """Kernel launches by family (the wrappers' counters)."""
    from repro_torch.kernels.paramspmm import ops as spmm_ops
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    if reset:
        spmm_ops.reset_launch_count()
        sddmm_ops.reset_launch_count()
    return {"paramspmm": spmm_ops.launch_count(),
            "sddmm_softmax": sddmm_ops.launch_count("sddmm_softmax"),
            "sddmm": sddmm_ops.launch_count("sddmm")}


class _obs_tracing:
    """The program's span tracing, on from here to ``stop()``."""

    def __init__(self):
        from repro_torch import obs
        self.obs = obs
        obs.start_tracing()

    def stop(self):
        events = self.obs.trace_events()
        self.obs.stop_tracing()
        return events


def _device(cell, device, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell.chips, "memory_peak_bytes": peak}


def _trace_context(cell, clock, steps, spans, adj, n, device, launches):
    """What the per-layer metric readers read."""
    prof = labels = None
    if clock.events:
        a0, a1 = clock.metric_steps
        prof = devtrace.DeviceWindow.from_events(clock.events[a0], a1 - a0)
        b0, b1 = clock.label_steps
        labels = devtrace.DeviceWindow.from_events(clock.events[b0], b1 - b0)
    plain = clock.unprofiled(steps)
    ops = work.step_ops(cell.config, n, adj.nnz)
    total = len(steps)
    if launches is not None:
        sys.stderr.write(f"[trace] launches over {total} window steps and "
                         f"step 0 and the evaluation: {launches}; the "
                         f"model's structure gives {work.launches(ops)} a "
                         "step\n")
    return SimpleNamespace(cell=cell, config=cell.config, n=n, nnz=adj.nnz,
                           ops=ops, prof=prof, labels=labels, spans=spans,
                           steps_s=plain, step_s=sum(plain) / len(plain),
                           adj=adj, device=device, launches=launches)
