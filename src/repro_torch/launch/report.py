"""The dry run's tables from ``launch/dryrun.py``'s JSON records, written
between the reference's markers into the file ``--target`` names
(idempotent: the block between the markers is replaced).

  PYTHONPATH=src python -m repro_torch.launch.report \
      --dir experiments/dryrun_torch --target DRYRUN_TORCH.md

The rows are the reference's (``repro/launch/report.py``); the text
around them says what the port's numbers are: a fake-process-group run
counted per rank, at the H100 data sheet's rates, not a card
measurement.  There is no default target: the repo's ``EXPERIMENTS.md``
belongs to the JAX package's dry run.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from . import roofline

DRYRUN_DIR = "experiments/dryrun_torch"
MARK_A = "<!-- AUTOGEN:DRYRUN -->"
MARK_B = "<!-- AUTOGEN:END -->"


def load(dirname=DRYRUN_DIR):
    rows = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def dryrun_table(rows):
    out = ["| arch | shape | mesh | compile_s | args GiB/dev | "
           "temp GiB/dev | collectives (count) |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"FAIL | | | {r.get('error','')} |")
            continue
        det = r.get("coll_detail", {})
        cd = "; ".join(f"{k}×{v[0]}" for k, v in sorted(det.items()))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('compile_s','')} | {fmt_bytes(r.get('arg_bytes',0))} | "
            f"{fmt_bytes(r.get('temp_bytes',0))} | {cd} |")
    return "\n".join(out)


def roofline_table(rows, mesh="single"):
    out = ["| arch | shape | t_compute s | t_memory s | t_collective s | "
           "bottleneck | MODEL_FLOPS | useful ratio |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if not r.get("ok") or r["mesh"] != mesh:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute']:.3f} | "
            f"{r['t_memory']:.3f} | {r['t_collective']:.3f} | "
            f"**{r['bottleneck']}** | {r['model_flops']:.2e} | "
            f"{r['useful_ratio']:.3f} |")
    return "\n".join(out)


CARD_BYTES = 80e9          # one H100 SXM5's HBM3


SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _fit_cell(r):
    if r is None:
        return "—"
    if not r.get("ok"):
        return "FAIL"
    b = r["per_device_bytes"]
    t = r["t_" + r["bottleneck"]]
    short = {"compute": "comp", "memory": "mem", "collective": "coll"}
    return (f"{fmt_bytes(b)}{'' if b < CARD_BYTES else ' ✗'}, "
            f"{short[r['bottleneck']]} {t:.3g}, {r['useful_ratio']:.2f}")


def fit_table(rows, mesh="single"):
    """One row per arch, one column per shape: per-device GiB (✗: over one
    card's 80 GB), the bottleneck and its seconds, the useful ratio."""
    by = {(r["arch"], r["shape"]): r for r in rows if r["mesh"] == mesh}
    archs = sorted({a for a, _ in by})
    out = ["| arch | " + " | ".join(SHAPE_ORDER) + " |",
           "|---|" + "---|" * len(SHAPE_ORDER)]
    for arch in archs:
        out.append(f"| {arch} | " + " | ".join(
            _fit_cell(by.get((arch, sh))) for sh in SHAPE_ORDER) + " |")
    return "\n".join(out)


def render(rows):
    ok = sum(1 for r in rows if r.get("ok"))
    return f"""{MARK_A}
## Dry run of the PyTorch port — fake process group, per-rank counts

Every (architecture × applicable shape) cell run once on a fake process
group: single pod (16×16 = 256 ranks, data×model) and multi-pod
(2×16×16 = 512 ranks, pod×data×model).  {ok} cells ran, {len(rows) - ok}
failed.  Args are rank 0's local shards of the step's arguments; temp
is the peak of the tensors the step allocates on rank 0.  These are
estimates from fake tensors, not measurements on a card.

{dryrun_table(rows)}

### Fit and bound (80 GB a card): GiB per device, bottleneck s, useful ratio

Single pod:

{fit_table(rows, "single")}

Multi-pod:

{fit_table(rows, "multi")}

## Roofline — per-cell terms (single pod)

compute = counted FLOPs per rank ÷ {roofline.PEAK_FLOPS / 1e12:.0f} TF/s;
memory = counted bytes per rank (operands read plus results written per
op, unfused) ÷ {roofline.HBM_BW / 1e12:.2f} TB/s; collective = Σ
collective result bytes ÷ {roofline.LINK_BW / 1e9:.0f} GB/s (H100 SXM5
data sheet; NDR InfiniBand per card).  ``useful ratio`` = MODEL_FLOPS /
(FLOPs × ranks).

{roofline_table(rows, "single")}

### Multi-pod (512-rank) roofline

{roofline_table(rows, "multi")}
{MARK_B}"""


def write(block, target):
    if os.path.exists(target):
        with open(target) as f:
            text = f.read()
        if MARK_A in text and MARK_B in text:
            text = text.split(MARK_A)[0] + block + text.split(MARK_B)[1]
        else:
            text = text + "\n" + block + "\n"
    else:
        text = block + "\n"
    with open(target, "w") as f:
        f.write(text)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DRYRUN_DIR)
    ap.add_argument("--target", required=True)
    args = ap.parse_args(argv)
    rows = load(args.dir)
    write(render(rows), args.target)
    print(f"wrote {args.target} ({len(rows)} records)")


if __name__ == "__main__":
    main()
