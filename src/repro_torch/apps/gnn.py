"""GNN training (paper §6.5): GCN, GIN and GAT on a node-classification
task, with ParamSpMM as the aggregation in the forward and the backward.

    PYTHONPATH=src python -m repro_torch.apps.gnn --model gcn --steps 20
    PYTHONPATH=src python -m repro_torch.apps.gnn --device cpu --model gat
    PYTHONPATH=src python -m repro_torch.apps.gnn --spmm cusparse

Every aggregation runs in a hand-written CUDA kernel on the card: GCN and
GIN layers are one ParamSpMM launch forward (epilogue fused) and one on
the transpose PCSR backward; a GAT layer is the fused SDDMM → softmax
stats and the ParamSpMM prologue forward, and the raw SDDMM plus three
ParamSpMM launches backward (``core.engine``).  On ``--device cpu`` the
kernels' plain versions run instead.  ``--spmm cusparse`` / ``gespmm``
trains GCN or GIN through the paper's baselines instead
(``core.baselines``: ``torch.sparse.mm`` on CSR, a row-wise gather +
``index_add_``).  Runs on CUDA unless told otherwise and raises without
a card.

``--partitions N`` (``train_gnn(partitions=N)``) trains on N row shards,
one process (rank) each over ``torch.distributed`` (``repro_torch.dist``):
every rank runs its own shard's kernels under its own ⟨W,F,V,S⟩ config
(no reorder: node ids stay aligned with the partition), exchanges halo
rows with collectives, and sums the parameter gradients with one
collective over a flat buffer, so the parameters stay equal on every
rank.  ``--overlap`` hides the halo gather behind the shard-local SpMM
(GCN, GIN); ``--dist-backend`` is ``nccl`` (default on CUDA, a card per
rank) or ``gloo`` (default on the CPU; on CUDA its ranks share the card,
the collectives staged through the host):

    PYTHONPATH=src python -m repro_torch.apps.gnn --device cpu --partitions 4
    PYTHONPATH=src python -m repro_torch.apps.gnn --partitions 4 \
        --dist-backend gloo

``--mutate N`` then streams N insert/delete churn batches through a
self-healing ``dynamic.DynamicGraph`` on the task's adjacency
(``run_mutation_stream``): one governor verdict a batch, and at the end
the degraded layout's aggregation against a fresh re-pack of the mutated
edges on the same device:

    PYTHONPATH=src python -m repro_torch.apps.gnn --device cpu --mutate 3

Spans (``repro_torch.obs``; ``--trace PATH`` writes them as Chrome-trace
JSON, which ``repro_torch.apps.obs_report`` reads; each is also a
``torch.profiler`` range): ``gnn.pack`` (reorder, config pick, PCSR of A
and Aᵀ), holding on one device ``pack.reorder``, ``pack.pick`` (absent
when a config is given) and ``pack.pcsr`` (two ``pcsr.build``);
``gnn.first_step`` (step 0: kernel build and load, allocator growth; for
GAT also ``gat.transpose_side``, Aᵀ's steering and slot transfer map,
built at the first backward) and ``gnn.step`` per later step, each
holding, with ``step=``, ``gnn.forward`` (the model and the loss),
``gnn.backward`` (autograd, and the partitioned gradient all-reduce),
``gnn.optimizer`` (AdamW) and ``gnn.sync`` (the loss to the host, the
device synchronised); ``gnn.eval``; with ``--mutate`` a ``gnn.mutate``
instant a batch and ``dynamic.repack`` per re-pack.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.baselines import (make_cusparse_analog,
                                        make_gespmm_analog)
from repro_torch.core.pcsr import SpMMConfig
from repro_torch.data.tasks import NodeTask
from repro_torch.device import resolve_device
from repro_torch.models.gnn import (accuracy, gat_forward, gcn_forward,
                                    gin_forward, init_gat, init_gcn,
                                    init_gin, node_ce_loss)
from repro_torch.obs import instant, span, tracing
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.pipeline import ParamSpMM


@dataclass
class GNNTrainResult:
    losses: list = field(default_factory=list)
    val_acc: float = 0.0
    seconds_per_step: float = 0.0      # mean over steps 1.. (step 0 builds
                                       # the kernels), on_step excluded;
                                       # partitioned: the slowest rank's
    config: SpMMConfig | list | None = None    # list: one per partition
    params: list | None = None         # the trained parameters (CPU)


def build_spmm(task: NodeTask, dim: int, mode: str = "paramspmm", *,
               partitions: int = 0, partition_strategy: str = "balanced",
               overlap: bool = False, dist_group=None, **kw):
    """SpMM operator over Â (the GCN-normalized adjacency): returns
    ``(op, perm, config)``.  ``mode`` is "paramspmm" (``kw`` go to
    ``ParamSpMM``), or a baseline of ``core.baselines``: "cusparse" or
    "gespmm", which take ``device`` only (any other keyword raises
    ``ValueError``) and return ``(fn, None, None)``.  ``partitions > 0``
    builds this rank's ``dist.DistGraph`` instead (inside a process
    group of that many ranks, ``dist_group`` or the world; ``kw`` go to
    ``DistGraph``; no reorder), and config is the per-shard list."""
    csr = task.csr.gcn_normalize()
    if partitions:
        if mode != "paramspmm":
            raise ValueError("partitioned execution needs mode='paramspmm'")
        from repro_torch.dist import DistGraph
        g = DistGraph(csr, dim, partitions, strategy=partition_strategy,
                      overlap=overlap, group=dist_group, **kw)
        return g, None, g.configs
    if overlap:
        raise ValueError("overlap needs partitions")
    if mode == "paramspmm":
        p = ParamSpMM(csr, dim, **kw)
        return p, p.perm, p.config
    baselines = {"cusparse": make_cusparse_analog,
                 "gespmm": make_gespmm_analog}
    if mode not in baselines:
        raise ValueError(f"unknown spmm mode {mode!r}")
    device = kw.pop("device", None)
    if kw:
        raise ValueError(f"the {mode} baseline takes device only, not "
                         f"{sorted(kw)}")
    return baselines[mode](csr, device), None, None


def _init_params(model, dims, heads, seed, device):
    gen = torch.Generator().manual_seed(seed)
    if model == "gcn":
        return init_gcn(dims, generator=gen, device=device)
    if model == "gin":
        return init_gin(dims, generator=gen, device=device)
    return init_gat(dims, generator=gen, device=device, heads=heads)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_rank(task, kw):
    """One rank of a spawned partitioned run (``comm.spawn``)."""
    return train_gnn(task, **kw)


def _spawn_training(task, partitions: int, backend, device, kw):
    """Start ``partitions`` ranks (``dist.comm.spawn``), train, return
    rank 0's result.  The kernels are built here first, so the ranks
    load them rather than each running ``nvcc``."""
    from repro_torch.dist import comm
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        resolve_device(dev)
    backend = backend or comm.default_backend(dev)
    comm.check_world(dev, partitions, backend)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build()
    if kw.get("params") is not None:
        kw["params"] = [{k: v.detach().cpu() for k, v in layer.items()}
                        for layer in kw["params"]]
    kw = dict(kw, partitions=partitions, device=str(dev))
    return comm.spawn(_train_rank, partitions, (task, kw), backend=backend,
                      device=dev)[0]


def train_gnn(task: NodeTask, *, model: str = "gcn", hidden: int = 64,
              n_layers: int = 5, steps: int = 100, lr: float = 5e-3,
              spmm_mode: str = "paramspmm", seed: int = 0, heads: int = 1,
              partitions: int = 0, partition_strategy: str = "balanced",
              overlap: bool = False, dist_backend: str | None = None,
              dist_group=None, fused: bool = True,
              spmm_kwargs: dict | None = None, params=None,
              device=None, on_step=None) -> GNNTrainResult:
    """Train ``model`` on ``task`` with AdamW(``lr``) for ``steps`` full
    batch steps on ``device`` (default CUDA).

    ``params`` are the initial parameters (a list of dicts of tensors,
    e.g. ``convert.params_to_torch`` of another package's); by default
    they are drawn from a ``torch.Generator`` seeded with ``seed``.
    ``fused=True`` lets GCN layers hand bias + ReLU, and GIN layers their
    ``(1+ε)h`` term, to the SpMM's fused epilogue; ``fused=False`` keeps
    ``spmm(h) @ W + b``.  GAT picks its config for the SDDMM + SpMM pair
    at ``heads`` heads and always packs the transpose PCSR for its
    backward.  ``spmm_kwargs`` go to ``ParamSpMM`` (``config=``,
    ``reorder=``, ``hardware=``, ...), or to ``DistGraph`` when
    partitioned.  ``on_step(step)`` is called after each step (e.g. a
    profiler's ``step``).

    ``partitions=N`` trains on N row shards (``partition_strategy``;
    ``overlap`` for GCN and GIN), one rank each.  Inside an initialised
    process group of N ranks (``dist_group``, default the world) it
    trains this rank's shard on ``device`` (default CUDA: ``cuda:rank``
    over NCCL, the ranks sharing the card over gloo); otherwise it spawns
    the N ranks over ``dist_backend`` (default ``nccl`` on CUDA, ``gloo``
    on the CPU) and returns rank 0's result.  Each rank's loss is its
    train rows' cross-entropy over the global train count; the
    gradients, the loss and the val_acc counts are summed over the ranks
    in rank order, so every rank holds the same parameters bit for bit.
    ``config`` is then the per-shard list."""
    if model not in ("gcn", "gin", "gat"):
        raise ValueError(f"unknown model {model!r}")
    comm = None
    if partitions:
        import torch.distributed as dist

        from repro_torch.dist import comm as dist_comm
        if not dist.is_initialized():
            kw = dict(model=model, hidden=hidden, n_layers=n_layers,
                      steps=steps, lr=lr, spmm_mode=spmm_mode, seed=seed,
                      heads=heads, partition_strategy=partition_strategy,
                      overlap=overlap, fused=fused, spmm_kwargs=spmm_kwargs,
                      params=params, on_step=on_step)
            return _spawn_training(task, partitions, dist_backend, device,
                                   kw)
        comm = dist_comm.Comm(dist_group)
        if dist_backend is not None and dist_backend != comm.backend:
            raise ValueError(f"dist_backend={dist_backend!r} inside a "
                             f"{comm.backend} process group")
        device = dist_comm.rank_device(device, comm.rank, comm.backend)
    device = resolve_device(device)
    kw = dict(spmm_kwargs or {})
    kw["device"] = device
    if model == "gat":
        if spmm_mode != "paramspmm":
            raise ValueError("gat needs the PCSR message fn "
                             "(spmm_mode='paramspmm')")
        kw.setdefault("op", "gat")
        kw.setdefault("heads", heads)
        if not partitions:
            kw["build_transpose"] = True
    with span("gnn.pack", model=model, mode=spmm_mode,
              partitions=partitions):
        spmm, perm, cfg = build_spmm(
            task, hidden, spmm_mode, partitions=partitions,
            partition_strategy=partition_strategy,
            overlap=overlap and model != "gat", dist_group=dist_group, **kw)
    graph = spmm
    if not fused and model != "gat":
        # hide the fusion surface: a plain closure → gcn/gin take the
        # unfused branch
        spmm = lambda B: graph(B)

    as_t = lambda a: torch.as_tensor(a, device=device)
    X, labels = as_t(task.features), as_t(task.labels).long()
    tmask, vmask = as_t(task.train_mask), as_t(task.val_mask)
    n_train = None
    if comm is not None:      # this rank's rows; counts are global
        X, labels, tmask, vmask = (graph.pad(a) for a in
                                   (X, labels, tmask, vmask))
        n_train = float(task.train_mask.sum())
    elif perm is not None:  # graph was reordered → permute node data
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        inv = as_t(inv)
        X, labels, tmask, vmask = X[inv], labels[inv], tmask[inv], vmask[inv]

    dims = [X.shape[1]] + [hidden] * (n_layers - 1) + [task.n_classes]
    if params is None:
        params = _init_params(model, dims, heads, seed, device)
    params = [{k: v.detach().to(device=device, dtype=torch.float32)
               .requires_grad_() for k, v in layer.items()}
              for layer in params]
    if model == "gcn":
        fwd = gcn_forward
    elif model == "gin":
        fwd = gin_forward
    else:
        if comm is not None:
            spmm = graph.gat_message
        else:
            from repro_torch.core.engine import make_gat_message_fn
            spmm = make_gat_message_fn(graph.op.pcsr, graph.op.pcsr_t)
        fwd = lambda p, x, msg: gat_forward(p, x, msg, heads=heads)

    opt_cfg = AdamWConfig(lr=lr)
    opt = adamw_init(params)
    res = GNNTrainResult(config=cfg)
    elapsed = 0.0
    for step in range(steps):
        t0 = time.perf_counter()
        with span("gnn.first_step" if step == 0 else "gnn.step", step=step):
            with span("gnn.forward", step=step):
                loss = node_ce_loss(fwd(params, X, spmm), labels, tmask,
                                    total=n_train)
            with span("gnn.backward", step=step):
                grads = torch.autograd.grad(loss, [v for layer in params
                                                   for v in layer.values()])
                if comm is not None:   # one collective: gradients and loss
                    flat = comm.all_reduce_sum(torch.cat(
                        [g.reshape(-1) for g in grads]
                        + [loss.detach().reshape(1)]))
                    loss = flat[-1]
                    grads = [f.reshape(g.shape) for f, g in zip(
                        flat[:-1].split([g.numel() for g in grads]), grads)]
            with span("gnn.optimizer", step=step):
                it = iter(grads)
                grads = [{k: next(it) for k in layer} for layer in params]
                params, opt = adamw_update(params, grads, opt, opt_cfg)
                params = [{k: v.requires_grad_() for k, v in layer.items()}
                          for layer in params]
            with span("gnn.sync", step=step):
                res.losses.append(float(loss.detach()))
                _sync(device)
        if step > 0:       # step 0 builds and loads the kernels
            elapsed += time.perf_counter() - t0
        if on_step is not None:        # outside the timed step
            on_step(step)
    if steps > 1:
        res.seconds_per_step = elapsed / (steps - 1)
    res.params = [{k: v.detach().cpu() for k, v in layer.items()}
                  for layer in params]
    with span("gnn.eval"), torch.no_grad():
        logits = fwd(params, X, spmm)
        if comm is None:
            res.val_acc = float(accuracy(logits, labels, vmask))
        else:
            right = ((logits.argmax(-1) == labels).to(vmask.dtype)
                     * vmask).sum()
            right = comm.all_reduce_sum(right.reshape(1))[0]
            res.val_acc = float(right / right.new_tensor(
                float(task.val_mask.sum())))      # as ``accuracy`` divides
            res.seconds_per_step = float(comm.all_gather(torch.tensor(
                [res.seconds_per_step], device=device)).max())
    return res


def run_mutation_stream(csr, dim: int, batches: int, *, seed: int = 0,
                        inserts: int = 150, deletes: int = 130,
                        slack: float = 1.1, amortize_steps: int = 20,
                        device=None):
    """Churn ``csr`` through a self-healing ``DynamicGraph`` on ``device``
    (default CUDA) and report each governor verdict; ends with the
    degraded layout's aggregation against a fresh re-pack of the mutated
    edges, on the same device."""
    from repro_torch.core.pcsr import build_pcsr
    from repro_torch.dynamic import DynamicGraph
    from repro_torch.kernels.paramspmm.ops import paramspmm

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    g = DynamicGraph(csr, dim, slack=slack, amortize_steps=amortize_steps,
                     device=device)
    X = torch.as_tensor(rng.standard_normal((csr.n_cols, dim)),
                        dtype=torch.float32, device=device)
    for step in range(batches):
        r, c = rng.integers(0, csr.n_rows, (2, inserts))
        g.insert_edges(r, c,
                       rng.uniform(0.5, 1.5, inserts).astype(np.float32))
        m = g.dyn.to_csr()
        rows = np.repeat(np.arange(m.n_rows), np.diff(m.indptr))
        pick = rng.permutation(m.nnz)[:deletes]
        _, dec = g.delete_edges(rows[pick], m.indices[pick])
        instant("gnn.mutate", step=step, action=dec.action)
        print(f"mutate[{step}]: nnz={g.dyn.nnz} chunks={g.dyn.num_chunks} "
              f"slot_fill={g.dyn.slot_fill:.2f} -> {dec.action} "
              f"({dec.reason})")
    out = g.spmm(X)
    m = g.dyn.to_csr()
    fresh = build_pcsr(m.indptr, m.indices, m.data, m.n_rows, m.n_cols,
                       g.config)
    err = float((out - paramspmm(fresh, X)).abs().max())
    n_repack = sum(d.action == "repack" for d in g.decisions)
    print(f"mutate: aggregation matches a fresh re-pack on {device} "
          f"(max |Δ| = {err:.2e}, summation-order noise only); "
          f"repacks={n_repack}")
    return g


def main(argv=None):
    from repro_torch.data.tasks import community_task

    ap = argparse.ArgumentParser(description="GNN training on a synthetic "
                                 "node-classification task")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    ap.add_argument("--model", default="gcn", choices=["gcn", "gin", "gat"])
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--heads", type=int, default=1)
    ap.add_argument("--spmm", default="paramspmm",
                    choices=["paramspmm", "cusparse", "gespmm"],
                    help="aggregation operator (the baselines: GCN/GIN)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--partitions", type=int, default=0,
                    help="row-partition the graph over N ranks "
                    "(0 = single device)")
    ap.add_argument("--partition-strategy", default="balanced",
                    choices=["contiguous", "balanced"])
    ap.add_argument("--overlap", action="store_true",
                    help="hide the halo gather behind the shard-local "
                    "SpMM (GCN, GIN; needs --partitions)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend of the ranks (default "
                    "nccl on CUDA, gloo on the CPU)")
    ap.add_argument("--mutate", type=int, default=0, metavar="N",
                    help="after training, stream N random insert/delete "
                    "churn batches through a self-healing DynamicGraph "
                    "on the task's adjacency (repro_torch.dynamic)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the run (read it "
                    "with repro_torch.apps.obs_report or Perfetto)")
    args = ap.parse_args(argv)

    import contextlib
    device = resolve_device(args.device)
    ctx = tracing(args.trace) if args.trace else contextlib.nullcontext()
    with ctx:
        task = community_task(seed=args.seed)
        res = train_gnn(task, model=args.model, hidden=args.hidden,
                        n_layers=args.layers, steps=args.steps,
                        heads=args.heads, seed=args.seed,
                        spmm_mode=args.spmm, partitions=args.partitions,
                        partition_strategy=args.partition_strategy,
                        overlap=args.overlap,
                        dist_backend=args.dist_backend, device=device)
        if args.mutate:
            run_mutation_stream(task.csr.gcn_normalize(), args.hidden,
                                args.mutate, seed=args.seed, device=device)
    if args.trace:
        print(f"trace written to {args.trace}")
    print(f"losses: {res.losses[0]:.4f} → {res.losses[-1]:.4f} over "
          f"{len(res.losses)} steps")
    print(f"val_acc={res.val_acc:.3f} "
          f"ms_per_step={res.seconds_per_step * 1e3:.1f} ({device})")
    if res.config is None:
        print(f"spmm: the {args.spmm} baseline")
    elif args.partitions:
        for i, c in enumerate(res.config):
            w, f, v, s, b = c.astuple()
            print(f"partition {i}: W={w} F={f} V={v} S={s} B={b}")
    else:
        w, f, v, s, b = res.config.astuple()
        print(f"config: W={w} F={f} V={v} S={s} B={b}")
    return res


if __name__ == "__main__":
    main()
