"""GNN inference serving driver — seeded stream replay through
``repro_torch.serve``.

    PYTHONPATH=src python -m repro_torch.apps.serve_gnn \\
        --graph rmat13 --model gcn --requests 32 --check

Replays a seeded bursty synthetic request stream through ``GNNService``
on ``--device`` (default ``cuda``; raises when there is no card) and
prints per-bucket traffic, cache hit/miss, kernel launches, the bucket
programs (on a card, one CUDA-graph capture each) with
``serve_recompiles_total``, and latency percentiles.  ``--check`` re-runs
every request through the full-pipeline reference forward on the CPU
(same subgraph, same config, no bucketing) and asserts the served outputs
match.  ``--stats PATH`` writes the summary JSON; ``--trace PATH`` also
exports the run's ``repro_torch.obs`` trace (serve spans + counters) as
Chrome-trace JSON.  The run is always traced, for the counters.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--graph", default="rmat13",
                    help="corpus('serve') graph name")
    ap.add_argument("--model", default="gcn", choices=["gcn", "gin", "gat"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--feat", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--tick-every", type=int, default=8)
    ap.add_argument("--cache-capacity", type=int, default=8)
    ap.add_argument("--check", action="store_true",
                    help="assert served outputs match the full-pipeline "
                    "reference forward on every request")
    ap.add_argument("--stats", default=None, metavar="PATH",
                    help="write summary JSON")
    ap.add_argument("--trace", nargs="?", const="serve_trace.json",
                    default=None, metavar="PATH")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.data.graphs import corpus
    from repro_torch.device import resolve_device
    from repro_torch.kernels.paramspmm import ops
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    from repro_torch.models.gnn import init_gat, init_gcn, init_gin
    from repro_torch.obs import metrics_snapshot, tracing
    from repro_torch.serve import (GNNService, reference_forward, replay,
                                   synthetic_stream)

    device = resolve_device(args.device)
    specs = {s.name: s for s in corpus("serve")}
    if args.graph not in specs:
        ap.error(f"--graph must be one of {sorted(specs)}")
    g = specs[args.graph].csr.gcn_normalize()

    rng = np.random.default_rng(args.seed)
    feats = rng.integers(0, 4, (g.n_rows, args.feat)).astype(np.float32)
    gen = torch.Generator().manual_seed(args.seed)
    dims = [args.feat, args.hidden, args.classes]
    init = {"gcn": init_gcn, "gin": init_gin, "gat": init_gat}[args.model]
    params = init(dims, generator=gen)

    stream = synthetic_stream(args.requests, g.n_rows, seed=args.seed)
    ops.reset_launch_count()
    sddmm_ops.reset_launch_count()
    with tracing(args.trace):
        svc = GNNService(g, feats, params, model=args.model, device=device,
                         cache_capacity=args.cache_capacity,
                         keep_subgraphs=args.check)
        results = replay(svc, stream, tick_every=args.tick_every)
        snap = {k: v for k, v in metrics_snapshot().items()
                if k.startswith("serve_")}
    launches = ops.launch_count() + sddmm_ops.launch_count()

    if len(results) != args.requests:
        raise RuntimeError(f"served {len(results)} of {args.requests}")
    lat = np.array([r.latency_s for r in results]) * 1e3
    cache = svc.cache
    per_bucket: dict = {}
    for r in results:
        per_bucket[r.bucket_key] = per_bucket.get(r.bucket_key, 0) + 1

    checked = 0
    # GAT's softmax sums run in another order on the card than in the
    # CPU reference's fresh pack
    tol = 1e-4 if args.model == "gat" and device.type == "cuda" else 1e-5
    if args.check:
        for r in results:
            sr = r.sampled
            ref = reference_forward(
                sr.sub, torch.from_numpy(feats[sr.nodes]), params,
                model=args.model, config=r.config).numpy()[sr.seed_local]
            np.testing.assert_allclose(r.outputs, ref, rtol=tol, atol=tol,
                                       err_msg=f"request {r.rid}")
            checked += 1
        if cache.hits == 0:
            raise RuntimeError("no steering-pack cache hits on the stream")
        print(f"check: {checked}/{len(results)} requests match the "
              f"full-pipeline reference")

    stats = {
        "graph": args.graph, "model": args.model, "device": str(device),
        "requests": len(results), "batches": len(svc.batch_log),
        "buckets": per_bucket,
        "cache_hits": cache.hits, "cache_misses": cache.misses,
        "cache_evictions": cache.evictions,
        "cache_hit_rate": cache.hit_rate,
        "compiled_buckets": svc.compiled_buckets,
        "serve_recompiles_total": sum(
            snap.get("serve_recompiles_total", {}).values()),
        "kernel_launches": launches,
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "checked": checked,
    }
    if args.trace:
        stats["counters"] = snap
    print(f"served {stats['requests']} requests in {stats['batches']} "
          f"batches across {len(per_bucket)} buckets on {device} "
          f"({launches} kernel launches)")
    print(f"cache: {cache.hits} hits / {cache.misses} misses "
          f"(hit rate {cache.hit_rate:.2f})")
    print(f"bucket programs: {svc.compiled_buckets} "
          f"({'CUDA graphs' if svc.graphs else 'eager'}), "
          f"serve_recompiles_total {stats['serve_recompiles_total']:g}")
    print(f"latency p50 {stats['latency_ms_p50']:.1f} ms, "
          f"p99 {stats['latency_ms_p99']:.1f} ms")
    if args.stats:
        with open(args.stats, "w") as fh:
            json.dump(stats, fh, indent=2)
        print(f"# wrote {args.stats}")
    return stats


if __name__ == "__main__":
    main()
