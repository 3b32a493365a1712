#!/usr/bin/env python3
"""Comparisons of two versions on one NVIDIA GPU, in one run.

    python3 chip_compare.py spmm ROOT [ROOT ...]
    python3 chip_compare.py sddmm ROOT [ROOT ...]
    python3 chip_compare.py serve ROOT [ROOT ...]
    python3 chip_compare.py scan ROOT [ROOT ...]
    python3 chip_compare.py gat ROOT [ROOT ...]
    python3 chip_compare.py sddmm-sum

``spmm`` times the ParamSpMM rows of ``chip_smoke.py``'s timing phase
(serving bucket with and without the bias + ReLU epilogue, rmat17 with
and without it, kreg150k; dim 64) with the ``chip_smoke.py`` and
``src/repro_torch`` of each checkout ROOT, each in a process of its own
and in the order given (give parent, change, change, parent to see the
drift).  ``sddmm`` does the same for the raw SDDMM rows (rmat17 and
kreg150k at their GAT-picked configs, and the GAT training packs of
``chip_smoke.py``'s 1,024- and 131,072-node graphs; dim 64), each with the kernel's
device time from ``torch.profiler`` beside its events.  ``serve`` runs
the serving phase of each ROOT's
``chip_smoke.py`` (GCN, GIN and GAT at full width on rmat13, each request
checked as that phase checks it: its 64-request stream a model, on a
fresh service ``SERVE_REPEATS`` times a process) and reads each model's
latency p50 / p99 and its host spans (``serve.sample``, ``serve.pack``,
``serve.forward``, ``serve.batch``) summed and per batch.  ``sddmm-sum`` builds ``csrc/sddmm_softmax.cu`` a second time with
a float64 Σexp (``-DREPRO_SDDMM_SUM=double``) and times it against the
shipped float32 Σexp on the GAT-picked configs of a serving bucket,
rmat17 (also at 4 heads) and kreg150k, and reads each one's largest
relative rowsum error against the plain version (whose Σexp is float64)
on rows with an edge, over three seeds.

Each prints a table and writes its rows as JSON under ``build/compare/``.
Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "compare"


def _need_card():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_compare: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _smoke(root: Path):
    """``chip_smoke`` of ``root``; it puts ``root/src`` on the path, so
    the ``repro_torch`` it drives is that checkout's."""
    sys.path.insert(0, str(root))
    import chip_smoke
    check = Path(chip_smoke.__file__).resolve().parent
    if check != root.resolve():
        sys.exit(f"chip_compare: imported {check}, wanted {root}")
    return chip_smoke


# --------------------------------------------------------------- spmm
def spmm_rows(root: Path) -> list:
    """The ParamSpMM timing rows of ``root``'s chip_smoke phase 5."""
    device = _need_card()
    cs = _smoke(root)
    cs.build.build()
    import numpy as np
    g = cs.rmat(13, 8, seed=31)
    union = cs._union(g, 8, seed=5)
    bucket = cs.BucketPolicy.default().pick(union.n_rows, union.nnz)
    cfg = cs.SteeringPackCache(dim=64).get(bucket, union).config
    p = cs.pack_subgraph(union, cs.PackGeom.from_bucket(bucket, cfg))
    padded = cs.CSRMatrix(np.concatenate([union.indptr, np.full(
        p.n_rows - union.n_rows, union.indptr[-1])]), union.indices,
        union.data, p.n_rows, p.n_rows)
    epi = {"bias": True, "activation": "relu"}
    rows = [cs.time_one(f"serve batch {bucket.key}", padded, p, 64, device),
            cs.time_one(f"serve batch {bucket.key}", padded, p, 64, device,
                        epi)]
    g17 = cs.rmat(17, 6, seed=22)
    p17 = cs.build_pcsr(g17.indptr, g17.indices, g17.data, g17.n_rows,
                        g17.n_cols, cs.pick_config(g17, 64))
    rows += [cs.time_one("rmat17", g17, p17, 64, device),
             cs.time_one("rmat17", g17, p17, 64, device, epi)]
    gk = cs.kregular(150_000, 6, seed=29)
    pk = cs.build_pcsr(gk.indptr, gk.indices, gk.data, gk.n_rows, gk.n_cols,
                       cs.pick_config(gk, 64))
    rows.append(cs.time_one("kreg150k", gk, pk, 64, device))
    for r in rows:
        r["epilogue"] = r.get("library_ms") is None
    return rows


# ------------------------------------------------------------- sddmm
def sddmm_rows(root: Path) -> list:
    """The raw SDDMM timing rows of ``root``'s chip_smoke phase 7, each
    with the kernel's device time per call on operands of its shape."""
    import torch
    device = _need_card()
    cs = _smoke(root)
    cs.build.build()
    from repro_torch.pipeline import ParamSpMM
    cases = []
    for label, g in (("rmat17", cs.rmat(17, 6, seed=22)),
                     ("kreg150k", cs.kregular(150_000, 6, seed=29))):
        cases.append((label, g, cs.build_pcsr(
            g.indptr, g.indices, g.data, g.n_rows, g.n_cols,
            cs.pick_config(g, 64, op="gat"))))
    for label, task in (
            ("community1k", cs.community_task()),
            ("community131k", cs.community_task(n_blocks=16,
                                                block_size=8192,
                                                p_in=0.0025))):
        op = ParamSpMM(task.csr.gcn_normalize(), 64, op="gat",
                       build_transpose=False, device=device)
        cases.append((label, op.csr, op.op.pcsr))
    rows = []
    for label, csr, p in cases:
        row = cs.time_sddmm(label, csr, p, 64, device)
        Q, K = (torch.randn((n, 64), device=device)
                for n in (p.n_rows, p.n_cols))
        rows.append((row, lambda p=p, Q=Q, K=K: cs.sddmm_ops.sddmm(p, Q,
                                                                   K)))
    # device times after every event timing, as chip_smoke's phase 7
    for row, call in rows:
        row["device_ms"] = cs.device_ms(call, "sddmm")
    return [row for row, _ in rows]


def run_sddmm(roots: list) -> int:
    import numpy as np
    runs = _runs("sddmm", roots)
    print("run | root | at | kernel ms | device ms | plain ms | library ms "
          "| bound ms")
    fmt = lambda x: "—" if x is None else f"{x:.4f}"
    for run in runs:
        for r in run["rows"]:
            print(f"{run['run']} | {run['root']} | {r['at']} | "
                  + " | ".join(fmt(r[k]) for k in (
                      "ms", "device_ms", "plain_ms", "library_ms",
                      "bound_ms")))
    print("root | at | rows | median kernel ms (min–max) | median device "
          "ms (min–max)")
    for root in dict.fromkeys(roots):
        for at in dict.fromkeys(r["at"] for run in runs
                                for r in run["rows"]):
            rows = [r for run in runs if run["root"] == root
                    for r in run["rows"] if r["at"] == at]
            cols = [[r["ms"] for r in rows],
                    [r["device_ms"] for r in rows
                     if r["device_ms"] is not None]]
            print(f"{root} | {at} | {len(rows)} | " + " | ".join(
                f"{np.median(c):.4f} ({min(c):.4f}–{max(c):.4f})"
                if c else "not measured" for c in cols))
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "compare_sddmm.json").write_text(json.dumps(runs, indent=1))
    return 0


def _runs(kind: str, roots: list) -> list:
    """``kind``'s rows of each root, each root in a process of its own,
    in the order given."""
    runs = []
    for i, root in enumerate(roots):
        res = subprocess.run([sys.executable, __file__, f"_{kind}_rows",
                              root], capture_output=True, text=True,
                             timeout=900)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            print(res.stdout[-4000:])
            sys.exit(f"chip_compare: run {i} ({root}) failed")
        runs.append({"run": i, "root": root,
                     "rows": json.loads(res.stdout.strip().splitlines()[-1])})
    return runs


def run_spmm(roots: list) -> int:
    runs = _runs("spmm", roots)
    print("run | root | at | epilogue | kernel ms | plain ms | library ms")
    for run in runs:
        for r in run["rows"]:
            lib = r["library_ms"]
            print(f"{run['run']} | {run['root']} | {r['at']} | "
                  f"{r['epilogue']} | {r['ms']:.4f} | {r['plain_ms']:.4f} | "
                  f"{'—' if lib is None else f'{lib:.4f}'}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "compare_spmm.json").write_text(json.dumps(runs, indent=1))
    return 0


# -------------------------------------------------------------- serve
SERVE_REPEATS = 3           # the phase's stream (64 requests, 8 batches)
SPANS = ("serve.sample", "serve.pack", "serve.forward", "serve.batch")


def serve_rows(root: Path) -> list:
    """One row per model of ``root``'s serving phase, its checks
    included: latency p50 / p99 (ms) and the host spans (ms, summed)."""
    import numpy as np
    device = _need_card()
    cs = _smoke(root)
    cs.build.build()
    rows, report = [], cs._report

    def keep(model, svc, results, spans, wall):
        report(model, svc, results, spans, wall)
        lat = np.array([r.latency_s for r in results]) * 1e3
        rows.append({"model": model, "requests": len(results),
                     "batches": len(svc.batch_log),
                     "p50_ms": float(np.percentile(lat, 50)),
                     "p99_ms": float(np.percentile(lat, 99)),
                     "wall_s": wall,
                     "spans_ms": {k: spans.get(k) for k in SPANS}})

    cs._report = keep
    for _ in range(SERVE_REPEATS):
        for model in ("gcn", "gin"):
            cs.phase_serve(model, device)
        cs.phase_serve_gat(device)
    return rows


def run_serve(roots: list) -> int:
    runs = _runs("serve", roots)
    print("run | root | model | batches | p50 ms | p99 ms | "
          + " | ".join(f"{k} ms/batch" for k in SPANS))
    for run in runs:
        for r in run["rows"]:
            per = [r["spans_ms"][k] for k in SPANS]
            print(f"{run['run']} | {run['root']} | {r['model']} | "
                  f"{r['batches']} | {r['p50_ms']:.3f} | {r['p99_ms']:.3f} | "
                  + " | ".join("—" if v is None
                               else f"{v / r['batches']:.4f}" for v in per))
    import numpy as np
    print("root | model | rows | median p50 ms (min–max) | median p99 ms "
          "(min–max) | median serve.pack ms/batch (min–max) | median "
          "serve.forward ms/batch (min–max)")
    for root in dict.fromkeys(roots):
        for model in ("gcn", "gin", "gat"):
            rows = [r for run in runs if run["root"] == root
                    for r in run["rows"] if r["model"] == model]
            cols = [[r["p50_ms"] for r in rows], [r["p99_ms"] for r in rows]]
            cols += [[r["spans_ms"][k] / r["batches"] for r in rows]
                     for k in ("serve.pack", "serve.forward")]
            print(f"{root} | {model} | {len(rows)} | " + " | ".join(
                f"{np.median(c):.4f} ({min(c):.4f}–{max(c):.4f})"
                for c in cols))
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "compare_serve.json").write_text(json.dumps(runs, indent=1))
    return 0


# --------------------------------------------------------------- scan
SCAN_SEED = 9


def _profiled_ms(fn, reps=10):
    """(device ms per call of the scan kernels, of every kernel) from one
    ``torch.profiler`` window over ``reps`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    scan = every = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        every += t
        if "selective_scan" in e.key:
            scan += t
    return scan / 1e3 / reps, every / 1e3 / reps


def scan_rows(root: Path) -> list:
    """The scan's three kernels of ``root`` at ``SCAN_BWD_TIMED``."""
    import hashlib
    import torch
    device = _need_card()
    cs = _smoke(root)
    cs.build.build(["selective_scan"])
    from repro_torch.core.autotune import time_fn
    from repro_torch.kernels.selective_scan import ops
    chunked = hasattr(ops, "CHUNK")            # chunk states, not every h
    rows = []
    for shape in cs.SCAN_BWD_TIMED:
        B, S, N, Di = shape
        g = torch.Generator(device=device).manual_seed(SCAN_SEED)
        dA = torch.rand(shape, generator=g, device=device) * 0.79 + 0.2
        dBx = torch.randn(shape, generator=g, device=device) * 0.1
        C = torch.randn((B, S, N), generator=g, device=device)
        gy = torch.randn((B, S, Di), generator=g, device=device)
        fwd = lambda: ops._launch(dA, dBx, C)
        if chunked:
            train = lambda: ops._launch(dA, dBx, C, states=True)
            kept = train()[1]
            bwd = lambda: ops.selective_scan_backward(dA, dBx, C, kept, gy)
        else:
            train = lambda: ops._launch(dA, dBx, C, keep_h=True)
            kept = train()[1]
            bwd = lambda: ops.selective_scan_backward(dA, C, kept, gy)
        y = fwd()[0]
        torch.cuda.synchronize()
        row = {"at": str(shape), "kept": "chunk states" if chunked
               else "every h", "kept_bytes": kept.numel() * 4,
               "y_sha256": hashlib.sha256(
                   y.cpu().numpy().tobytes()).hexdigest(),
               "train_y_equal": bool(torch.equal(train()[0], y))}
        for name, fn in (("forward", fwd), ("train_forward", train),
                         ("backward", bwd)):
            row[f"{name}_ms"] = time_fn(fn, reps=20, warmup=3) * 1e3
            (row[f"{name}_kernel_device_ms"],
             row[f"{name}_all_device_ms"]) = _profiled_ms(fn)
        rows.append(row)
        del dA, dBx, C, gy, kept, y
        torch.cuda.empty_cache()
    return rows


SCAN_COLS = ("forward", "train_forward", "backward")


def _scan_cell(r, k):
    return (f"{r[k + '_ms']:.4f} ({r[k + '_kernel_device_ms']:.4f} / "
            f"{r[k + '_all_device_ms']:.4f})")


def run_scan(roots: list) -> int:
    import numpy as np
    runs = _runs("scan", roots)
    print("run | root | at | kept | " + " | ".join(
        f"{k} ms (kernel / all, profiler)" for k in SCAN_COLS)
        + " | y sha256 | training y equal")
    for run in runs:
        for r in run["rows"]:
            print(f"{run['run']} | {run['root']} | {r['at']} | {r['kept']} | "
                  + " | ".join(_scan_cell(r, k) for k in SCAN_COLS)
                  + f" | {r['y_sha256'][:16]} | {r['train_y_equal']}")
    print("root | at | rows | " + " | ".join(
        f"median {k} ms (min–max)" for k in SCAN_COLS))
    for root in dict.fromkeys(roots):
        for at in dict.fromkeys(r["at"] for run in runs
                                for r in run["rows"]):
            rows = [r for run in runs if run["root"] == root
                    for r in run["rows"] if r["at"] == at]
            cols = [[r[k + "_ms"] for r in rows] for k in SCAN_COLS]
            print(f"{root} | {at} | {len(rows)} | " + " | ".join(
                f"{np.median(c):.4f} ({min(c):.4f}–{max(c):.4f})"
                for c in cols))
    for at in dict.fromkeys(r["at"] for run in runs for r in run["rows"]):
        hashes = {r["y_sha256"] for run in runs for r in run["rows"]
                  if r["at"] == at}
        print(f"{at}: inference forward output "
              + ("the same bits in every run" if len(hashes) == 1
                 else f"{len(hashes)} different hashes"))
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "compare_scan.json").write_text(json.dumps(runs, indent=1))
    return 0


# ---------------------------------------------------------------- gat
def gat_rows(root: Path) -> list:
    """``root``'s phase-6 GAT training on the 131k task: ms per step,
    device ms per step by kernel family, and whether its two runs agree
    bit for bit."""
    device = _need_card()
    cs = _smoke(root)
    cs.build.build()
    res, per_step, dev, spans, prof_ms, ran = cs.train_on_card(
        cs._large_task(), "gat", device, 5)
    return [{"model": "gat", "nodes": cs._large_task().csr.n_rows,
             "ms_per_step": res.seconds_per_step * 1e3,
             "device_ms_per_step": dev, "losses": res.losses,
             "val_acc": res.val_acc}]


def run_gat(roots: list) -> int:
    import numpy as np
    runs = _runs("gat", roots)
    fams = list(runs[0]["rows"][0]["device_ms_per_step"])
    print("run | root | ms/step | " + " | ".join(f"{k} device ms"
                                                for k in fams))
    for run in runs:
        for r in run["rows"]:
            print(f"{run['run']} | {run['root']} | {r['ms_per_step']:.3f} | "
                  + " | ".join(f"{r['device_ms_per_step'][k]:.4f}"
                               for k in fams))
    print("root | rows | median other device ms (min–max) | losses of "
          "every run the same bits")
    for root in dict.fromkeys(roots):
        rows = [r for run in runs if run["root"] == root
                for r in run["rows"]]
        other = [r["device_ms_per_step"]["other"] for r in rows]
        same = len({tuple(r["losses"]) for r in rows}) == 1
        print(f"{root} | {len(rows)} | {np.median(other):.4f} "
              f"({min(other):.4f}–{max(other):.4f}) | {same}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "compare_gat.json").write_text(json.dumps(runs, indent=1))
    return 0


# ---------------------------------------------------------- sddmm-sum
def _sum_variant_libs(cs):
    """The shipped ``sddmm_softmax`` library and the same source built
    with a float64 Σexp, the second loaded through the wrapper's own
    ``_lib`` so it gets the same argument types."""
    build, ops = cs.build, cs.sddmm_ops
    src = build.CSRC_DIR / "sddmm_softmax.cu"
    path = build.BUILD_DIR / "libsddmm_softmax-sum_double.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS,
                    "-DREPRO_SDDMM_SUM=double", "-o", str(path), str(src)],
                   check=True, capture_output=True, timeout=600)
    shipped = ops._lib("sddmm_softmax")
    load = build.load
    build.load = lambda name: ctypes.CDLL(str(path))
    try:
        del ops._LIBS["sddmm_softmax"]
        variant = ops._lib("sddmm_softmax")
    finally:
        build.load = load
        ops._LIBS["sddmm_softmax"] = shipped
    return shipped, variant


def run_sddmm_sum() -> int:
    import numpy as np
    import torch
    device = _need_card()
    cs = _smoke(ROOT)
    ops = cs.sddmm_ops
    libs = dict(zip(("float32", "float64"), _sum_variant_libs(cs)))
    g = cs.rmat(13, 8, seed=31)
    union = cs._union(g, 8, seed=5)
    bucket = cs.BucketPolicy.default().pick(union.n_rows, union.nnz)
    cfg = cs.SteeringPackCache(dim=64, op="gat").get(bucket, union).config
    cases = [(f"serve batch {bucket.key}",
              cs.pack_subgraph(union, cs.PackGeom.from_bucket(bucket, cfg)),
              1, 64)]
    for label, gr in (("rmat17", cs.rmat(17, 6, seed=22)),
                      ("kreg150k", cs.kregular(150_000, 6, seed=29))):
        p = cs.build_pcsr(gr.indptr, gr.indices, gr.data, gr.n_rows,
                          gr.n_cols, cs.pick_config(gr, 64, op="gat"))
        cases.append((label, p, 1, 64))
        if label == "rmat17":
            cases.append((label, p, 4, 16))
    rows = []
    for label, p, H, d in cases:
        c = p.config
        steer = ops.device_steering(p, device)
        geo = dict(V=c.V, R=c.R, K=p.K, n_blocks=p.n_blocks, n_rows=p.n_rows)
        row = {"at": label, "config": list(c.astuple()), "H": H, "dim": d,
               "nnz": p.nnz}
        for seed in range(3):
            rng = np.random.default_rng(seed)
            Q, K = (torch.from_numpy(rng.standard_normal(
                (H, n, d)).astype(np.float32)).to(device)
                for n in (p.n_rows, p.n_cols))
            want = ops.sddmm_softmax_plain(steer, Q, K, scale=float(
                1.0 / np.sqrt(d)), slope=cs.SLOPE, **geo)
            has = want[2] > 0
            for name, lib in libs.items():
                ops._LIBS["sddmm_softmax"] = lib
                got = ops.sddmm_softmax_stats(p, Q, K)
                torch.cuda.synchronize()
                cs.check(torch.equal(got[0], want[0])
                         or torch.allclose(got[0], want[0], rtol=1e-5,
                                           atol=1e-5),
                         f"{label}: logits differ ({name})")
                rel = ((got[2] - want[2]).abs() / want[2])[has]
                key = f"rowsum_rel_err_{name}"
                row[key] = max(row.get(key, 0.0), float(rel.max()))
        Q1, K1 = (torch.randn((H, n, d), device=device)
                  for n in (p.n_rows, p.n_cols))
        for rep in range(2):                    # f32, f64, f64, f32
            for name in (("float32", "float64") if rep == 0
                         else ("float64", "float32")):
                ops._LIBS["sddmm_softmax"] = libs[name]
                ms = cs.cuda_ms(lambda: ops.sddmm_softmax_stats(p, Q1, K1))
                row.setdefault(f"ms_{name}", []).append(ms)
        ops._LIBS["sddmm_softmax"] = libs["float32"]
        rows.append(row)
        print(f"{label} {tuple(c.astuple())} H={H} d={d}: "
              f"float32 Σexp {row['ms_float32']} ms, float64 Σexp "
              f"{row['ms_float64']} ms; max rel rowsum err vs plain "
              f"float32 {row['rowsum_rel_err_float32']:.3e}, float64 "
              f"{row['rowsum_rel_err_float64']:.3e}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "compare_sddmm_sum.json").write_text(json.dumps(rows, indent=1))
    return 0


def main(argv) -> int:
    rows = {"_spmm_rows": spmm_rows, "_sddmm_rows": sddmm_rows,
            "_serve_rows": serve_rows, "_scan_rows": scan_rows,
            "_gat_rows": gat_rows}
    if len(argv) == 2 and argv[0] in rows:
        print(json.dumps(rows[argv[0]](Path(argv[1]))))
        return 0
    if len(argv) >= 2 and argv[0] == "spmm":
        return run_spmm(argv[1:])
    if len(argv) >= 2 and argv[0] == "sddmm":
        return run_sddmm(argv[1:])
    if len(argv) >= 2 and argv[0] == "serve":
        return run_serve(argv[1:])
    if len(argv) >= 2 and argv[0] == "scan":
        return run_scan(argv[1:])
    if len(argv) >= 2 and argv[0] == "gat":
        return run_gat(argv[1:])
    if argv == ["sddmm-sum"]:
        return run_sddmm_sum()
    sys.exit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
