"""SpMM-decider training harness (paper §5-6.3).

Labels come from the oracle search over the ⟨W,F,V,S⟩ space: cost-model
pricing at corpus scale (``--mode model``, at the data-sheet ``H100`` or
through ``--calibration``), or the port's kernels timed on the card
(``--mode measured``).  The train/test split is BY GRAPH to avoid
leakage (the paper's 80/20 split of matrices).

``--op {spmm,sddmm,gat}`` selects the operator the labels are for, so
one harness trains a per-operator decider: ``--op gat`` labels each
(graph, dim) with the config minimising the SDDMM → softmax-stats pass
plus the prologue SpMM.

    PYTHONPATH=src python -m repro_torch.apps.decider_train --device cpu
    PYTHONPATH=src python -m repro_torch.apps.decider_train \
        --device cuda --mode measured --scale large --dims 32,64,128
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.autotune import oracle_search
from repro_torch.core.cost_model import CostModel
from repro_torch.core.decider import RandomForest, SpMMDecider
from repro_torch.core.features import extract_features
from repro_torch.data.graphs import corpus
from repro_torch.device import resolve_device
from repro_torch.obs import span, tracing

DIMS = tuple(range(16, 257, 16))           # the paper's dim sweep


@dataclass
class DeciderDataset:
    samples: list                          # (features, dim, best_cfg)
    times: dict                            # (gname, dim) -> {cfg: time}
    graph_names: list
    by_graph: dict                         # gname -> [sample indices]
    op: str = "spmm"                       # operator the labels price


def build_dataset(graphs=None, dims=DIMS, mode: str = "model",
                  op: str = "spmm", H: int = 1, calibration=None,
                  verbose=False, device=None) -> DeciderDataset:
    """``H`` is the head count the oracle labels are collected for —
    multi-head GAT deciders must be trained on ``H``-aware labels (the
    optimal F/V/S shifts with the per-head dim), not the H=1 ones.

    ``calibration`` (a ``CalibrationResult`` or artifact path) makes the
    model-mode labels come from the *fitted* cost model — the decider
    then learns the config ranking the card measurably exhibits instead
    of the data-sheet one.  Ignored in measured mode, whose labels are
    the kernels' times on ``device`` (default CUDA); each graph is
    packed once per config for all its dims."""
    graphs = graphs if graphs is not None else corpus("bench")
    if calibration is not None and not hasattr(calibration, "price"):
        from repro_torch.core.calibrate import CalibrationResult
        calibration = CalibrationResult.load(calibration)
    samples, times, by_graph = [], {}, {}
    for g in graphs:
        t0 = time.time()
        with span("decider.label_graph", graph=g.name, mode=mode, op=op):
            feats = extract_features(g.csr)
            cm = (CostModel(g.csr, calibration=calibration)
                  if mode == "model" else None)
            packs: dict = {}
            for dim in dims:
                res = oracle_search(g.csr, dim, mode=mode, cm=cm, op=op,
                                    H=H, device=device, packs=packs)
                samples.append((feats, dim, res.best_config))
                times[(g.name, dim)] = res.times
                by_graph.setdefault(g.name, []).append(len(samples) - 1)
        if verbose:
            print(f"  {g.name}: {time.time()-t0:.1f}s", flush=True)
    return DeciderDataset(samples, times, [g.name for g in graphs],
                          by_graph, op)


@dataclass
class DeciderEval:
    per_dim: dict                          # dim -> (pred_norm, rnd_norm)
    overall_pred: float
    overall_rnd: float
    decider: SpMMDecider
    # decider-vs-oracle quality on the held-out graphs: how often the
    # predicted config matches the oracle-best time (price ties count),
    # and the time ratio paid when it does not (regret = t_pred/t_best ≥ 1)
    per_dim_quality: dict = field(default_factory=dict)
    #   dim -> {"agreement": .., "mean_regret": ..}
    agreement: float = 0.0
    mean_regret: float = 1.0
    max_regret: float = 1.0


def train_eval(ds: DeciderDataset, *, test_frac=0.2, seed=0,
               n_estimators=60) -> DeciderEval:
    rng = np.random.default_rng(seed)
    names = list(ds.graph_names)
    rng.shuffle(names)
    n_test = max(1, int(len(names) * test_frac))
    test_names = set(names[:n_test])
    train_idx = [i for n in names[n_test:] for i in ds.by_graph[n]]
    test_idx = [i for n in test_names for i in ds.by_graph[n]]

    decider = SpMMDecider(
        forest=RandomForest(n_estimators=n_estimators, seed=seed))
    decider.fit([ds.samples[i] for i in train_idx])

    per_dim: dict = {}
    key_of = {}
    for n in ds.graph_names:
        for i in ds.by_graph[n]:
            key_of[i] = n
    for i in test_idx:
        feats, dim, best = ds.samples[i]
        tt = ds.times[(key_of[i], dim)]
        t_best = tt[best]
        pred = decider.predict(feats, dim)
        t_pred = tt.get(pred, max(tt.values()))
        rnd_cfg = list(tt)[int(rng.integers(len(tt)))]
        e = per_dim.setdefault(dim, [[], [], [], []])
        e[0].append(t_best / t_pred)       # normalized perf (throughput)
        e[1].append(t_best / tt[rnd_cfg])
        # agreement up to price ties: several configs often price
        # identically, so the oracle's exact tuple is arbitrary — what
        # matters is whether the pick costs what the best one costs
        e[2].append(1.0 if t_pred <= t_best * 1.001 else 0.0)
        e[3].append(t_pred / max(t_best, 1e-300))      # regret ≥ 1
    agg = {d: (float(np.mean(v[0])), float(np.mean(v[1])))
           for d, v in sorted(per_dim.items())}
    quality = {d: {"agreement": float(np.mean(v[2])),
                   "mean_regret": float(np.mean(v[3]))}
               for d, v in sorted(per_dim.items())}
    allp = [x for v in per_dim.values() for x in v[0]]
    allr = [x for v in per_dim.values() for x in v[1]]
    alla = [x for v in per_dim.values() for x in v[2]]
    allg = [x for v in per_dim.values() for x in v[3]]
    return DeciderEval(agg, float(np.mean(allp)), float(np.mean(allr)),
                       decider, per_dim_quality=quality,
                       agreement=float(np.mean(alla)),
                       mean_regret=float(np.mean(allg)),
                       max_regret=float(np.max(allg)))


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train + evaluate the "
                                 "⟨W,F,V,S⟩ decider")
    ap.add_argument("--device", default="cuda",
                    help="torch device the measured labels are timed on "
                    "(cuda, or cpu for the plain versions)")
    ap.add_argument("--op", default="spmm",
                    choices=["spmm", "sddmm", "gat"],
                    help="operator the oracle labels are collected for")
    ap.add_argument("--mode", default="model",
                    choices=["model", "measured"],
                    help="label source: cost-model pricing or the "
                    "kernels' times on --device")
    ap.add_argument("--heads", type=int, default=1,
                    help="head count the oracle labels are collected for "
                    "(multi-head GAT deciders need H-aware labels)")
    ap.add_argument("--scale", default="small",
                    choices=["small", "bench", "skewed", "large"],
                    help="graph corpus")
    ap.add_argument("--dims", default=None,
                    help="comma-separated embedding dims (default: paper "
                    "sweep 16..256)")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="calibration artifact (repro_torch.core.calibrate "
                    "JSON): model-mode labels come from the fitted cost "
                    "model instead of the hand-set constants")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None,
                    help="pickle the trained decider to this path")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the labeling + "
                    "training run (per-graph spans, oracle decision log)")
    args = ap.parse_args(argv)

    import contextlib
    ctx = tracing(args.trace) if args.trace else contextlib.nullcontext()
    dims = (tuple(int(d) for d in args.dims.split(","))
            if args.dims else DIMS)
    device = resolve_device(args.device)
    with ctx:
        ds = build_dataset(corpus(args.scale), dims=dims, mode=args.mode,
                           op=args.op, H=args.heads,
                           calibration=args.calibration, verbose=True,
                           device=device)
        with span("decider.train_eval", n_samples=len(ds.samples)):
            ev = train_eval(ds, seed=args.seed)
    if args.trace:
        print(f"trace written to {args.trace}")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"op={args.op} mode={args.mode} H={args.heads} device={where} "
          f"calibrated={args.calibration is not None} "
          f"graphs={len(ds.graph_names)}")
    for d, (pred, rnd) in ev.per_dim.items():
        q = ev.per_dim_quality[d]
        print(f"  dim={d:4d}  pred_norm={pred:.3f}  random_norm={rnd:.3f}"
              f"  agreement={q['agreement']:.2f}"
              f"  regret={q['mean_regret']:.3f}")
    print(f"overall: pred={ev.overall_pred:.3f} random={ev.overall_rnd:.3f} "
          f"agreement={ev.agreement:.3f} mean_regret={ev.mean_regret:.3f} "
          f"max_regret={ev.max_regret:.3f}")
    if args.save:
        ev.decider.save(args.save)
        print(f"saved decider to {args.save}")
    return ev


if __name__ == "__main__":
    main()
