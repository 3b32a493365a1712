#!/usr/bin/env python3
"""Comparisons of two versions on one NVIDIA GPU, in one run.

    python3 chip_compare.py spmm ROOT [ROOT ...]
    python3 chip_compare.py sddmm ROOT [ROOT ...]
    python3 chip_compare.py serve ROOT [ROOT ...]
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
            "_serve_rows": serve_rows}
    if len(argv) == 2 and argv[0] in rows:
        print(json.dumps(rows[argv[0]](Path(argv[1]))))
        return 0
    if len(argv) >= 2 and argv[0] == "spmm":
        return run_spmm(argv[1:])
    if len(argv) >= 2 and argv[0] == "sddmm":
        return run_sddmm(argv[1:])
    if len(argv) >= 2 and argv[0] == "serve":
        return run_serve(argv[1:])
    if argv == ["sddmm-sum"]:
        return run_sddmm_sum()
    sys.exit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
