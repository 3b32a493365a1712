"""Cost-model calibration: fit priced time to measured kernel time.

The analytic cost model (``cost_model.py``) prices the exact grid a
config packs, but its constants — the ``Hardware`` entry's memory rate,
float32 rate, ``step_overhead`` and ``chunk_setup`` — are data-sheet
figures and placeholders (0) for the card.  This module fits them:

1. **Design** (``build_design``): ``oracle_search(mode="measured")``
   times the port's kernels over a (graph × config × dim × op) design
   drawn from the corpus, and records beside each measured time the
   *feature columns* of the priced grid: the constant (per-call
   dispatch), bytes moved, MACs, grid steps and chunk setups
   (``CostBreakdown.chunk_setups``).  Each ``Hardware`` constant is
   exactly one column's coefficient.
2. **Fit** (``fit`` / ``fit_columns``): non-negative least squares
   (Lawson–Hanson, numpy only) on relative residuals — timing samples
   span orders of magnitude, so each sample is weighted by 1/t.
   Non-negativity keeps every coefficient physical (seconds per byte,
   per FLOP, per step, per chunk).
3. **Artifact** (``CalibrationResult.save/load``): a JSON file in
   ``configs/`` (the card's: ``configs/calibration_h100.json``) that
   ``CostModel.from_calibration`` consumes.  The format is the JAX
   package's, so an artifact of either package loads in the other.

``spearman`` + ``gate_design`` are the verification half: how well the
price orders configs the way the device does.

    python -m repro_torch.core.calibrate --device cuda --scale large \
        --dims 32,64 --out configs/calibration_h100.json
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from .cost_model import H100, CostBreakdown, CostModel, Hardware
from .pcsr import config_space

__all__ = [
    "COLUMNS", "GATE_GRAPHS", "GATE_DIMS", "GATE_REPS",
    "CalibrationSample", "CalibrationResult",
    "breakdown_features", "reference_coefficients",
    "nnls", "fit_columns", "fit", "spearman",
    "build_design", "gate_design", "run_calibration",
]

# Feature columns of the fit — one per additive cost term.  The analytic
# model's constants are exactly these columns' reference coefficients
# (``reference_coefficients``); the fit replaces them with measured ones.
COLUMNS = ("const", "bytes", "flops", "steps", "chunks")

# The pinned rank-correlation design: 3 graphs of ``corpus("small")``
# spanning power-law / uniform / preferential-attachment degree
# distributions, 2 dims, seeded measured oracle with pinned reps.
GATE_GRAPHS = ("rmat10", "er1k", "ba1k")
GATE_DIMS = (32, 64)
GATE_REPS = 3


def reference_coefficients(hardware: Hardware = H100) -> dict:
    """``hardware``'s constants as fit coefficients — the
    "pre-calibration" point every fit is compared against (``const`` is 0:
    the analytic model prices no per-call dispatch)."""
    return {"const": 0.0, "bytes": 1.0 / hardware.hbm_bw,
            "flops": 1.0 / hardware.flops,
            "steps": hardware.step_overhead,
            "chunks": hardware.chunk_setup}


def breakdown_features(bd: CostBreakdown) -> np.ndarray:
    """Feature vector of one priced kernel pass, in ``COLUMNS`` order."""
    return np.array([1.0, bd.bytes_total, bd.flops, float(bd.steps),
                     float(bd.chunk_setups)], np.float64)


# ------------------------------------------------------------------ fit
def nnls(A, b, max_iter: int | None = None) -> np.ndarray:
    """Non-negative least squares ``min ‖Ax − b‖₂ s.t. x ≥ 0`` —
    Lawson–Hanson active-set, numpy only."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    m, n = A.shape
    x = np.zeros(n)
    P = np.zeros(n, bool)                    # active (positive) set
    w = A.T @ (b - A @ x)                    # dual / gradient
    tol = 10 * np.finfo(np.float64).eps * np.linalg.norm(A, 1) * max(m, n)
    max_iter = max_iter or 3 * n
    it = 0
    while (~P).any() and np.max(np.where(~P, w, -np.inf)) > tol:
        P[int(np.argmax(np.where(~P, w, -np.inf)))] = True
        while True:
            z = np.zeros(n)
            z[P] = np.linalg.lstsq(A[:, P], b, rcond=None)[0]
            if np.min(z[P]) > 0:
                break
            mask = P & (z <= 0)
            alpha = np.min(x[mask] / (x[mask] - z[mask]))
            x = x + alpha * (z - x)
            P[x <= tol] = False
            it += 1
            if it > max_iter:
                break
        x = z.copy()
        x[~P] = 0.0
        w = A.T @ (b - A @ x)
        it += 1
        if it > max_iter:
            break
    return x


def fit_columns(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """NNLS coefficients of ``y ≈ X @ coef`` on *relative* residuals.

    Rows are weighted by ``1/y`` (minimize Σ((ŷ−y)/y)² — a 10 µs miss on
    a 20 µs call matters as much as a 10 ms miss on a 20 ms call), and
    columns are max-scaled before the solve so the active-set pivoting is
    not dominated by the raw magnitude spread (bytes ~1e6 vs const 1).
    """
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    w = 1.0 / np.maximum(y, 1e-12)
    Xw = X * w[:, None]
    scale = Xw.max(axis=0)
    scale[scale == 0] = 1.0
    return nnls(Xw / scale, np.ones_like(y)) / scale


def spearman(x, y) -> float:
    """Spearman rank correlation (average ranks on ties, numpy-only) —
    the "does the price order configs like the hardware" metric every
    speed claim is gated on."""
    def rank(a):
        a = np.asarray(a, np.float64)
        order = np.argsort(a, kind="stable")
        s = a[order]
        new_grp = np.concatenate([[True], s[1:] != s[:-1]])
        grp = np.cumsum(new_grp) - 1
        counts = np.bincount(grp)
        csum = np.concatenate([[0], np.cumsum(counts)])
        avg = (csum[:-1] + csum[1:] - 1) / 2.0 + 1
        out = np.empty(a.shape[0])
        out[order] = avg[grp]
        return out

    rx, ry = rank(x), rank(y)
    rx -= rx.mean()
    ry -= ry.mean()
    denom = np.sqrt((rx * rx).sum() * (ry * ry).sum())
    if denom == 0:
        return 0.0
    return float((rx * ry).sum() / denom)


# --------------------------------------------------------------- design
@dataclass
class CalibrationSample:
    """One (graph × op × dim × config) cell of the measured design."""

    graph: str
    op: str
    dim: int
    config: tuple                 # SpMMConfig.astuple() — JSON-friendly
    features: np.ndarray          # (len(COLUMNS),) priced grid extents
    measured: float               # seconds (median of pinned reps)
    priced: float                 # analytic CostModel.time (pre-calibration)


def build_design(graphs, dims=GATE_DIMS, ops=("spmm",), space=None,
                 reps: int = GATE_REPS, rng_seed: int = 0, H: int = 1,
                 verbose: bool = False, device=None
                 ) -> list[CalibrationSample]:
    """Measured (graph × config × dim × op) design over the corpus.

    ``graphs`` is a list of ``repro_torch.data.graphs.GraphSpec``.  Every
    cell times the kernels on ``device`` (default CUDA) through
    ``oracle_search(mode="measured")`` and prices the same cell's grid
    extents into ``features``: the matched pair the fit
    and the rank check both consume.  Each graph is packed once per
    config, for all its dims and ops.
    """
    from .autotune import oracle_search

    samples: list[CalibrationSample] = []
    for g in graphs:
        cm = CostModel(g.csr)
        packs: dict = {}
        for dim in dims:
            sp = space or config_space(dim)
            for op in ops:
                res = oracle_search(g.csr, dim, space=sp, mode="measured",
                                    reps=reps, rng_seed=rng_seed, op=op,
                                    H=H, device=device, packs=packs)
                for cfg in sp:
                    bd = cm.cost(dim, cfg, op, H=H)
                    samples.append(CalibrationSample(
                        g.name, op, dim, cfg.astuple(),
                        breakdown_features(bd), res.times[cfg],
                        cm.time(dim, cfg, op, H=H)))
            if verbose:
                print(f"  design: {g.name} dim={dim} "
                      f"({len(samples)} samples)", flush=True)
    return samples


def gate_design(reps: int = GATE_REPS, device=None
                ) -> list[CalibrationSample]:
    """The pinned small-corpus design: ``GATE_GRAPHS`` × ``GATE_DIMS`` ×
    the full config space, op="spmm", seeded operands, ``reps``
    pinned."""
    from repro_torch.data.graphs import corpus

    graphs = [g for g in corpus("small") if g.name in GATE_GRAPHS]
    assert len(graphs) == len(GATE_GRAPHS)
    return build_design(graphs, dims=GATE_DIMS, ops=("spmm",), reps=reps,
                        device=device)


# ------------------------------------------------------------- artifact
@dataclass
class CalibrationResult:
    """Fitted per-op coefficients + fit provenance.

    ``coef`` maps op → {column → seconds-per-unit}.  Ops are fitted
    separately (the SpMM and SDDMM kernels have different efficiency),
    and an op missing from the fit falls back to the "spmm"
    coefficients.  ``meta`` records the design (graphs, dims, reps,
    host, device) and in-sample diagnostics (per-op Spearman ρ, n).
    """

    coef: dict
    meta: dict = field(default_factory=dict)

    def coefficients(self, op: str = "spmm") -> np.ndarray:
        c = self.coef.get(op) or self.coef.get("spmm") \
            or next(iter(self.coef.values()))
        return np.array([c[name] for name in COLUMNS], np.float64)

    def price(self, bd: CostBreakdown, op: str = "spmm") -> float:
        """Seconds of one kernel pass under the fitted model."""
        return float(breakdown_features(bd) @ self.coefficients(op))

    def stream_seconds(self, nbytes: float, op: str = "spmm", *,
                       hbm_bw: float = H100.hbm_bw) -> float:
        """Seconds to stream ``nbytes`` of pure elementwise traffic (the
        unfused passes between kernels).  Uses the fitted bytes
        coefficient; when the fit zeroed it (byte traffic hidden behind
        MACs), falls back to ``hbm_bw`` so the penalty never silently
        vanishes."""
        c = float(self.coefficients(op)[COLUMNS.index("bytes")])
        return nbytes * (c if c > 0 else 1.0 / hbm_bw)

    def predict(self, samples) -> np.ndarray:
        return np.array([s.features @ self.coefficients(s.op)
                         for s in samples])

    # ------------------------------------------------------ persistence
    def to_dict(self) -> dict:
        return {"columns": list(COLUMNS), "coef": self.coef,
                "meta": self.meta}

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationResult":
        if list(d.get("columns", [])) != list(COLUMNS):
            raise ValueError(
                f"calibration artifact columns {d.get('columns')} do not "
                f"match this build's {list(COLUMNS)}")
        return cls(coef=d["coef"], meta=d.get("meta", {}))

    def save(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, sort_keys=True)
            fh.write("\n")

    @classmethod
    def load(cls, path) -> "CalibrationResult":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


def fit(samples, meta: dict | None = None) -> CalibrationResult:
    """Per-op weighted NNLS over a measured design, with in-sample
    diagnostics (Spearman ρ pre/post, n) recorded into ``meta``."""
    by_op: dict[str, list[CalibrationSample]] = {}
    for s in samples:
        by_op.setdefault(s.op, []).append(s)
    coef, diag = {}, {}
    for op, ss in sorted(by_op.items()):
        X = np.stack([s.features for s in ss])
        y = np.array([s.measured for s in ss])
        c = fit_columns(X, y)
        coef[op] = dict(zip(COLUMNS, c.tolist()))
        diag[op] = {
            "n": len(ss),
            "rho_pre": spearman([s.priced for s in ss], y),
            "rho_post": spearman(X @ c, y),
        }
    out_meta = dict(meta or {})
    out_meta["diagnostics"] = diag
    return CalibrationResult(coef=coef, meta=out_meta)


# ------------------------------------------------------------------ CLI
def run_calibration(scale: str = "small", dims=GATE_DIMS,
                    ops=("spmm", "sddmm"), reps: int = GATE_REPS,
                    max_nnz: int = 150_000, max_graphs: int | None = None,
                    out: str | None = None, verbose: bool = False,
                    device=None):
    """End-to-end calibration pass on ``device`` (default CUDA): corpus
    tier → measured design → fit → (optionally) saved JSON artifact.
    Returns (result, samples)."""
    import platform

    from repro_torch.data.graphs import corpus
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    graphs = [g for g in corpus(scale) if g.csr.nnz <= max_nnz]
    if max_graphs:
        graphs = graphs[:max_graphs]
    samples = build_design(graphs, dims=dims, ops=ops, reps=reps,
                           verbose=verbose, device=device)
    result = fit(samples, meta={
        "scale": scale, "graphs": [g.name for g in graphs],
        "dims": list(dims), "ops": list(ops), "reps": reps,
        "max_nnz": max_nnz, "max_graphs": max_graphs,
        "host": platform.platform(), **_device_meta(device),
    })
    if out:
        result.save(out)
        if verbose:
            print(f"wrote {out}")
    return result, samples


def _device_meta(device) -> dict:
    """What the times of an artifact were measured on and how: the torch
    device, its name, what a time spans and, on CUDA, ``nvidia-smi``'s
    name and power limit."""
    import subprocess

    import torch

    if device.type != "cuda":
        return {"backend": device.type, "device": device.type,
                "timing": "host clock around each call of the plain "
                "versions"}
    meta = {"backend": "cuda",
            "device": torch.cuda.get_device_name(device),
            "timing": "device time of each call: a CUDA event pair "
            "around it while a spin kernel holds the stream "
            "(core.autotune.time_fn), no host dispatch"}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        smi = res.stdout.strip().splitlines()
        idx = device.index or 0
        meta["nvidia_smi"] = smi[idx] if len(smi) > idx else "unavailable"
    except (OSError, subprocess.SubprocessError):
        meta["nvidia_smi"] = "unavailable"
    return meta


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Fit the cost model's constants to measured kernel "
        "time and save the calibration artifact")
    ap.add_argument("--device", default="cuda",
                    help="torch device whose kernels are timed (cuda, or "
                    "cpu for the plain versions)")
    ap.add_argument("--scale", default="small",
                    choices=["small", "skewed", "bench", "large"])
    ap.add_argument("--dims", default=None,
                    help="comma-separated dims (default: 32,64)")
    ap.add_argument("--ops", default="spmm,sddmm")
    ap.add_argument("--reps", type=int, default=GATE_REPS)
    ap.add_argument("--max-nnz", type=int, default=150_000)
    ap.add_argument("--max-graphs", type=int, default=None,
                    help="keep only the first N graphs of the tier")
    ap.add_argument("--fast", action="store_true",
                    help="tiny design: 2 graphs, one dim, 2 reps")
    ap.add_argument("--out", default=None,
                    help="write the JSON artifact here (e.g. "
                    "configs/calibration_h100.json)")
    args = ap.parse_args(argv)

    dims = (tuple(int(d) for d in args.dims.split(","))
            if args.dims else GATE_DIMS)
    kw = dict(scale=args.scale, dims=dims,
              ops=tuple(args.ops.split(",")), reps=args.reps,
              max_nnz=args.max_nnz, max_graphs=args.max_graphs,
              out=args.out, verbose=True, device=args.device)
    if args.fast:
        kw.update(dims=dims[:1], reps=2, max_graphs=2)
    result, samples = run_calibration(**kw)
    print(f"device: {result.meta.get('device')} "
          f"({result.meta.get('nvidia_smi', 'no nvidia-smi')})")
    for op, d in result.meta["diagnostics"].items():
        print(f"{op}: n={d['n']} rho_pre={d['rho_pre']:.3f} "
              f"rho_post={d['rho_post']:.3f}")
    for op, c in result.coef.items():
        print(f"{op} coefficients: " + " ".join(
            f"{k}={v:.3e}" for k, v in c.items()))
    return result, samples


if __name__ == "__main__":
    main()
