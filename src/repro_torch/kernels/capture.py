"""CUDA-graph capture of a call that launches the port's kernels, with the
kernels' launch counts kept true under replay.

The JAX package compiles its serving paths once per static shape: one
``jax.jit`` forward per serving bucket (``repro/serve/forward.py``) and
one jitted LM ``decode_step`` (``repro/launch/serve.py``).  The port
captures the same calls as CUDA graphs and replays them, so a replay
costs one host call in place of one Python dispatch per kernel.

A kernel wrapper counts a launch in Python where it enqueues the kernel.
Under capture it enqueues nothing, and a replay runs no Python, so
``capture`` takes back what the capture counted and ``Captured.replay``
adds it again on every replay: the counts stay one per kernel run.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.paramspmm import ops as spmm_ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.kernels.selective_scan import ops as scan_ops


def launch_counts() -> dict:
    """Every kernel's launch count, by kernel name."""
    return {"paramspmm": spmm_ops.launch_count(),
            **{k: sddmm_ops.launch_count(k) for k in sddmm_ops.KERNELS},
            "selective_scan": scan_ops.launch_count()}


def count_launches(counts: dict) -> None:
    """Add ``counts`` (kernel name → launches) to the kernels' counts."""
    for name, n in counts.items():
        if not n:
            continue
        if name == "paramspmm":
            spmm_ops.count_launches(n)
        elif name == "selective_scan":
            scan_ops.count_launches(n)
        else:
            sddmm_ops.count_launches(name, n)


# device index → the one side stream its warm-ups and captures run on.
# cuBLAS keeps a workspace (32 MiB on Hopper) for every stream it has run
# on, for the life of the process, so a fresh stream per capture would
# leave one behind each time, up to PyTorch's pool of 32 streams (1 GiB).
_SIDE: dict = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _SIDE:
        _SIDE[index] = torch.cuda.Stream(index)
    return _SIDE[index]


@dataclass
class Captured:
    """A captured call: its graph, its static output and the kernel
    launches one replay makes."""

    graph: "torch.cuda.CUDAGraph"
    out: object
    launches: dict

    def replay(self):
        """Run the graph on the current stream; returns the static output,
        which the next replay overwrites."""
        self.graph.replay()
        count_launches(self.launches)
        return self.out


def capture(fn, device, *, pool=None):
    """Run ``fn()`` eagerly once on a side stream, then capture ``fn()``
    into a CUDA graph on ``device``, on the same stream (one per device,
    shared by every capture).

    The eager run is the warm-up: it loads the kernels' libraries and
    makes their one-time settings (``cudaFuncSetAttribute``), and lets
    cuBLAS set up its workspace, all outside the capture.  ``fn`` must
    read its inputs from, and keep its state in, tensors whose addresses
    stay fixed, since the graph replays the addresses it captured.
    ``pool`` is a ``torch.cuda.graph_pool_handle()`` that several graphs
    share.  Returns ``(the eager run's result, Captured)``.  A capture
    that fails raises; nothing falls back to eager execution."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    main = torch.cuda.current_stream(device)
    side = _side_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        first = fn()
    main.wait_stream(side)
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool,
                                                     stream=side):
        out = fn()
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    count_launches({k: -n for k, n in launches.items()})
    return first, Captured(graph, out, launches)
