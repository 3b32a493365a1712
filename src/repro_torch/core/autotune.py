"""Oracle config search: exhaustive pricing or timing of the config space.

Two modes:
  * "model"    — the analytic cost model (``core.cost_model``), at the
    data-sheet ``Hardware`` or through a calibration artifact: the label
    source at corpus scale;
  * "measured" — the port's own kernels, timed on the device: on CUDA
    each config's ParamSpMM / SDDMM kernels with CUDA events, on the CPU
    (``device="cpu"``, the tests) their plain versions on the host clock.

The reference's measured mode times its engine's SpMM and raw SDDMM on a
host, with B padded to the config's dim tile.  Here the operands stay at
the per-head dim the main path gives the kernels (the CUDA kernels tile
columns by ``Dblk`` themselves, so F is paid as it is in use), and
``op="gat"`` times the two kernels the port's GAT forward runs: the
SDDMM → softmax-stats kernel plus the ParamSpMM softmax prologue.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.obs import (decisions as _obs_decisions,
                             metrics as _obs_metrics, trace as _obs_trace)

from .cost_model import CostModel
from .pcsr import SpMMConfig, build_pcsr, config_space
from .sparse import CSRMatrix


# the hold of ``time_fn``: spin cycles per second (at least the SM clock of
# an H100, so a hold lasts at least as long as asked), its floor and cap,
# and how many times the host's time per call it allows for each rep
HOLD_CYCLES_PER_S = 2.0e9
HOLD_MIN_S, HOLD_MAX_S, HOLD_MARGIN = 2e-2, 0.2, 8.0


def time_fn(fn, *args, reps: int = 3, warmup: int = 1,
            device=None) -> float:
    """Median seconds of one ``fn(*args)``.

    On CUDA (the default; raises without a card): ``warmup`` calls, then
    the device times of ``reps`` calls, one pair of CUDA events around
    each, read after one synchronize; the median of the pairs' times.  A
    spin kernel (``torch.cuda._sleep``) holds the stream while the calls
    are enqueued, with Python's garbage collector paused, so each pair
    times the device's work and none of the host's dispatch.  The hold
    is ``HOLD_MARGIN`` times the warm-up's host time per call for each
    rep (within ``HOLD_MIN_S``..``HOLD_MAX_S``); a hold that ended
    before the last call was enqueued raises.  On the CPU: the host
    clock around each call.  Every call ``fn`` makes — warm-up included
    — is a launch of its kernels."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn(*args)
    host_per_call = (time.perf_counter() - t0) / warmup if warmup else 1e-4
    if device.type == "cuda":
        hold = min(HOLD_MAX_S, max(HOLD_MIN_S,
                                   HOLD_MARGIN * reps * host_per_call))
        event = lambda: torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        held, released, pairs = event(), event(), []
        collecting = gc.isenabled()
        gc.disable()                 # no collection pause while held
        try:
            held.record()
            torch.cuda._sleep(int(hold * HOLD_CYCLES_PER_S))
            released.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                start, end = event(), event()
                start.record()
                fn(*args)
                end.record()
                pairs.append((start, end))
            enqueued = time.perf_counter() - t0
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(device)
        if enqueued >= held.elapsed_time(released) / 1e3:
            raise RuntimeError(
                f"time_fn: enqueueing {reps} calls took {enqueued:.6f} s, "
                f"longer than the stream was held "
                f"({held.elapsed_time(released) / 1e3:.6f} s); the times "
                "would include the host's dispatch")
        ts = [s.elapsed_time(e) / 1e3 for s, e in pairs]
    else:
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    _obs_metrics.counter("autotune_measurements_total").inc(reps)
    return float(np.median(ts))


@dataclass
class OracleResult:
    times: dict            # config -> seconds
    best_config: SpMMConfig
    best_time: float


def oracle_search(csr: CSRMatrix, dim: int, space=None, mode: str = "model",
                  reps: int = 3, rng_seed: int = 0,
                  cm: CostModel | None = None,
                  op: str = "spmm", H: int = 1,
                  calibration=None, device=None, warmup: int = 1,
                  packs: dict | None = None) -> OracleResult:
    """Exhaustive search of ``space`` (default ``config_space(dim)``) for
    operator ``op`` ("spmm", "sddmm", or "gat": the SDDMM → softmax-stats
    pass plus the prologue SpMM, priced or timed as the sum of the two).

    ``H`` is the head count the labels are for: multi-head layers run
    the head axis over the per-head dim ``ceil(dim/H)``.  Model mode
    prices ``cm.time(..., H=H)``, with ``cm`` by default a ``CostModel``
    at the data-sheet ``H100`` through ``calibration`` (a
    ``CalibrationResult`` or an artifact path; ignored when ``cm`` is
    given and in measured mode).

    Measured mode runs on ``device`` (default CUDA; raises without a
    card): per config, the PCSR pack, its device steering and the
    seeded operands are built outside the timed region, then
    ``time_fn(reps=, warmup=)`` times each kernel call.  Each config
    launches each timed kernel ``warmup + reps`` times (the plain
    versions on the CPU, which launch nothing).  ``packs`` (config →
    PCSR) reuses packs across calls on the same matrix.
    """
    if op not in ("spmm", "sddmm", "gat"):
        raise ValueError(op)
    if H < 1:
        raise ValueError(f"H must be ≥ 1, got {H}")
    space = space or config_space(dim)
    with _obs_trace.span("oracle.search", mode=mode, op=op, dim=dim, H=H,
                         n_configs=len(space)):
        if mode == "model":
            if cm is None:
                if calibration is not None and not hasattr(calibration,
                                                           "price"):
                    from .calibrate import CalibrationResult
                    calibration = CalibrationResult.load(calibration)
                cm = CostModel(csr, calibration=calibration)
            times = {cfg: cm.time(dim, cfg, op, H=H) for cfg in space}
        elif mode == "measured":
            times = _measured_times(csr, dim, space, reps, warmup,
                                    rng_seed, op, H, device, packs)
        else:
            raise ValueError(mode)
    best = min(times, key=times.get)
    if _obs_trace.trace_enabled():
        _obs_decisions.record_decision(
            csr, source=f"oracle_{mode}", op=op, dim=dim, heads=H,
            chosen=best, predicted_seconds=times[best],
            candidates=times.items(),
            calibration=cm.calibration if cm is not None else calibration)
    return OracleResult(times, best, times[best])


def _measured_times(csr, dim, space, reps, warmup, rng_seed, op, H, device,
                    packs) -> dict:
    from repro_torch.device import resolve_device
    from repro_torch.kernels.paramspmm import ops
    from repro_torch.kernels.sddmm import ops as sddmm_ops

    device = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    d_head = -(-dim // H)
    lead = (H,) if H > 1 else ()
    draw = lambda n: torch.from_numpy(rng.standard_normal(
        lead + (n, d_head)).astype(np.float32)).to(device)
    B = draw(csr.n_cols)
    if op != "spmm":
        Q, K = draw(csr.n_rows), draw(csr.n_cols)
    timed = lambda fn: time_fn(fn, reps=reps, warmup=warmup, device=device)
    times = {}
    for cfg in space:
        pcsr = None if packs is None else packs.get(cfg)
        if pcsr is None:
            pcsr = build_pcsr(csr.indptr, csr.indices, csr.data,
                              csr.n_rows, csr.n_cols, cfg)
            if packs is not None:
                packs[cfg] = pcsr
        steer = ops.device_steering(pcsr, device)
        # the head axis runs every head over the one steering
        vals = steer.vals.expand(lead + steer.vals.shape).contiguous() \
            if H > 1 else None
        t = 0.0
        if op == "spmm":
            t += timed(lambda: ops.paramspmm_with_vals(pcsr, vals, B))
        if op == "sddmm":
            t += timed(lambda: sddmm_ops.sddmm(pcsr, Q, K))
        if op == "gat":
            kept = [None]        # the last stats call's output feeds the
                                 # prologue: no launch outside time_fn

            def stats():
                kept[0] = sddmm_ops.sddmm_softmax_stats(pcsr, Q, K)
            t += timed(stats)
            logits, rowmax, rowsum = kept[0]
            t += timed(lambda: ops.paramspmm_with_vals(
                pcsr, logits, B, stats=(rowmax, rowsum)))
        times[cfg] = t
    return times


def throughput_gflops(csr: CSRMatrix, dim: int, seconds: float) -> float:
    """Useful GFLOP/s (2·nnz·dim MACs), the paper's reporting unit."""
    return 2.0 * csr.nnz * dim / seconds / 1e9
