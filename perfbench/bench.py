"""What every run shares: the cell's files found by name from
``BENCHMARK.json``, the graph cache, the checks against ``jax`` and the
JAX package, and the result line."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path

PB = Path(__file__).resolve().parent          # perfbench/
ROOT = PB.parent                              # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level names


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""
    name: str
    chips: int
    config_name: str
    config: dict                  # configs/<config>.json
    traffic_name: str
    traffic: dict                 # traffic/<traffic>.json
    spec: dict                    # cells/<name>.json: window and limits
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: Path = PB


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)




def load_cell(name: str, root: Path = PB) -> Cell:
    """The cell ``name`` of ``<root>/../BENCHMARK.json``; raises
    ``KeyError`` for a name the file does not hold."""
    bench = _json(root.parent / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    # an end-to-end metric without ``workloads`` is every cell's; a
    # per-layer metric names its cells
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=wl["chips"], config_name=wl["config"],
                config=_json(root.parent / cfg_entry["file"]),
                traffic_name=wl["traffic"],
                traffic=_json(root / "traffic" / f"{wl['traffic']}.json"),
                spec=_json(root / "cells" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, root=root)


def load_module(kind: str, name: str, root: Path = PB):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    mod_name = f"perfbench_{kind}_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_graph(cell: Cell):
    """The traffic's graph ``(indptr, indices, n)``: generated from its
    own graph seed, saved under ``cache/`` by the first run in a checkout
    (a fixed name per traffic, generator and parameters) and loaded from
    there by later runs."""
    import numpy as np
    t = cell.traffic
    gen = cell.root / "graphs" / f"{t['generator']}.py"
    key = hashlib.sha1(json.dumps(
        [t["generator"], t["graph_seed"], t["graph"]],
        sort_keys=True).encode() + gen.read_bytes()
        + (cell.root / "graphs" / "_csr.py").read_bytes()).hexdigest()[:12]
    path = cell.root / "cache" / f"{cell.traffic_name}-{key}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["indptr"], z["indices"], int(z["n"])
    mod = load_module("graphs", t["generator"], cell.root)
    indptr, indices, n = mod.generate(t["graph_seed"], **t["graph"])
    path.parent.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, indptr=indptr, indices=indices, n=n)
    os.replace(tmp, path)
    return indptr, indices, n


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is ``jax``, ``jaxlib``,
    ``flax`` or the JAX package ``repro``, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile by nearest rank: the value with ⌈q·n⌉ − 1
    values below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def judge(checks: dict) -> bool:
    """Every compared number finite and within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def emit(result: dict, checks: dict) -> None:
    """Each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output,
    the checks under the key that comes last."""
    for k, c in checks.items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr, flush=True)
    line = dict(result)
    line.pop("checks", None)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
