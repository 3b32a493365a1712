"""Run one cell of the port's benchmark:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It needs as many CUDA devices as the cell asks for and exits non-zero,
printing no result, without them.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit, also the last lines of standard error).  See README.md.
"""
import time

T_START = time.perf_counter()        # set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches():
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into ``build/repro_torch``)."""
    base = ROOT / "build" / "perfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from perfbench import bench
    cell = bench.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3
    driver = bench.load_module("drivers", cell.traffic["driver"])
    result, checks = driver.run(cell, args.seed, args.seconds,
                                bool(args.trace), T_START)
    found = bench.forbidden_modules()
    if found:
        print(f"modules of jax or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    bench.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
