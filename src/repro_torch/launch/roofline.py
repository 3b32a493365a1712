"""Roofline terms of the LM configs: parameter counts from the model
defs and the 6·N / 2·N rule per token, the H100 data-sheet constants,
and a counter of what a step costs per rank.

The JAX package's ``launch/roofline.py`` reads its terms from a compiled
XLA artifact: ``cost_analysis()`` for FLOPs, and parsers of the HLO text
for collective bytes (``collective_bytes``) and a fusion-aware HBM
estimate (``hbm_bytes_fused``).  The port runs a step eagerly on fake
tensors instead and counts in dispatch (``cost_counter``): FLOPs per
rank, bytes per rank as operands read plus results written per op (the
raw, unfused count: eager PyTorch fuses nothing, so this stands where
the reference's fused estimate would), and count and bytes per
collective kind.  ``chip_smoke.py`` states each LM run's model FLOPs
with ``model_flops_for``, and their share of the card's dense bf16
peak."""
from __future__ import annotations

import math

import torch

from repro_torch.models import lm


def param_count(cfg) -> tuple[float, float]:
    """(total, active) parameter counts from ``lm.model_defs``: an MoE
    expert leaf (``layers/ew*``) counts ``top_k / n_experts`` of itself
    as active."""
    counts = [0, 0]

    def add(path, leaf):
        n = math.prod(leaf[0])
        counts[0] += n
        if path[0] in ("layers", "glayers") and path[1].startswith("ew"):
            n = n * cfg.top_k // max(1, cfg.n_experts)
        counts[1] += n

    lm.map_defs(add, lm.model_defs(cfg))
    return float(counts[0]), float(counts[1])


def model_flops_for(cfg, cell) -> float:
    """6·N_active·tokens for train; 2·N_active·tokens for prefill; one
    token a sequence for decode."""
    _, active = param_count(cfg)
    if cell.kind == "train":
        return 6.0 * active * cell.seq_len * cell.global_batch
    if cell.kind == "prefill":
        return 2.0 * active * cell.seq_len * cell.global_batch
    return 2.0 * active * cell.global_batch


# --------------------------------------------------------------- roofline
# One NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet (dense, no sparsity, at
# the 700 W limit).  LINK_BW: the 16-wide model axis spans two 8-GPU HGX
# nodes, so its collectives cross the nodes' NDR InfiniBand, 400 Gb/s =
# 50 GB/s per GPU per direction; inside a node NVLink 4 gives 450 GB/s per
# direction.
PEAK_FLOPS = 989e12          # bf16 / card
HBM_BW = 3.35e12             # B/s / card (HBM3)
LINK_BW = 50e9               # B/s / card, NDR InfiniBand per direction

# the functional collectives DTensor issues, by the reference's kind names
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}


def _tensors(x):
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def scan_kernel_cost(name, args, out) -> tuple[float, float]:
    """(FLOPs, bytes) of one selective-scan custom-op call: the CUDA
    kernel's own traffic, each operand read once and each result written
    once (``chip_smoke.py``'s ``_scan_bound`` / ``_scan_backward_bound``),
    and 4 (forward) / 8 (backward) FLOPs per state element and step."""
    B, S, N, Di = args[0].shape
    if name == "selective_scan_fwd":
        return 4.0 * B * S * N * Di, float(_nbytes(args[:3]) + _nbytes(out))
    return 8.0 * B * S * N * Di, float(_nbytes(args) + _nbytes(out))


# DTensor's sharding propagation: run outside the counter, uncounted
PROPAGATION = ("propagate_op_sharding_non_cached",
               "_propagate_tensor_meta_non_cached")
# a strided shard's index arithmetic: run on real index tensors
STRIDED = ("_to_replicate_tensor", "_replicate_to_strided_shard",
           "local_shard_size_and_offset", "_local_shard_size_and_offset")


def _real_indices(f):
    """``f`` (a plain, static or class method) run with the fake mode off."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    kind = type(f)
    fn = f.__func__ if kind in (staticmethod, classmethod) else f

    def run(*a, **k):
        with unset_fake_temporarily():
            return fn(*a, **k)

    return kind(run) if kind in (staticmethod, classmethod) else run


def cost_counter():
    """A ``FakeTensorMode`` that counts, per rank, what every op on its
    local (fake) tensors would cost: ``flops`` (``torch.utils.
    flop_counter``'s formulas), ``bytes`` (operands read plus results
    written, per op: eager PyTorch fuses nothing, so this is the raw,
    unfused count where the reference estimated XLA's fused traffic),
    and per collective kind a count and the bytes of its result (the
    reference's proxy).  The selective scan's custom ops count the
    kernel's own bytes (``scan_kernel_cost``), not its plain loop.
    DTensor's sharding propagation runs ops on global-shaped fakes to
    learn output shapes; those are not counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils.flop_counter import flop_registry

    free = {"empty", "empty_strided", "empty_like", "new_empty",
            "new_empty_strided", "detach", "alias", "lift_fresh",
            "device", "wait_tensor"}

    class Counter(FakeTensorMode):
        def __init__(self):
            super().__init__(allow_non_fake_inputs=True)
            self.flops = 0.0
            self.bytes = 0.0
            self.coll = {}
            self._quiet = 0
            self._depth = 0

        def __enter__(self):
            # entered again from inside (DTensor re-enters the fake mode
            # of its arguments): patch once, on the outermost entry
            self._depth += 1
            if self._depth == 1:
                self._patch()
            return super().__enter__()

        def __exit__(self, *exc):
            self._depth -= 1
            if self._depth == 0:
                self._unpatch()
            return super().__exit__(*exc)

        def _patch(self):
            # DTensor's sharding propagation (strategies and output
            # metadata) runs outside this mode and uncounted
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            me = self
            self._orig = {n: getattr(ShardingPropagator, n)
                          for n in PROPAGATION if hasattr(ShardingPropagator,
                                                          n)}

            def quiet(orig):
                def run(prop, *a, **k):
                    me._quiet += 1
                    try:
                        with unset_fake_temporarily():
                            return orig(prop, *a, **k)
                    finally:
                        me._quiet -= 1
                return run

            for n, f in self._orig.items():
                setattr(ShardingPropagator, n, quiet(f))
            # a strided shard's index arithmetic builds real index tensors
            # (its results are read on the host); its data stays fake
            self._strided = {n: _StridedShard.__dict__[n] for n in STRIDED
                             if n in _StridedShard.__dict__}
            for n, f in self._strided.items():
                setattr(_StridedShard, n, _real_indices(f))

        def _unpatch(self):
            for n, f in self._orig.items():
                setattr(ShardingPropagator, n, f)
            for n, f in self._strided.items():
                setattr(_StridedShard, n, f)

        def dispatch(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = super().dispatch(func, types, args, kwargs)
            if out is NotImplemented or self._quiet:
                return out
            name = func.__name__.split(".")[0]
            ns = func.namespace
            if ns == "_c10d_functional":
                kind = COLLECTIVE_KINDS.get(name)
                if kind is not None:
                    e = self.coll.setdefault(kind, [0, 0])
                    e[0] += 1
                    e[1] += _nbytes(_tensors(out))
                return out
            if ns == "repro_torch":
                f, b = scan_kernel_cost(name, _tensors(args), _tensors(out))
                self.flops += f
                self.bytes += b
                return out
            pk = func._overloadpacket
            if pk in flop_registry:
                self.flops += float(flop_registry[pk](*args, **kwargs,
                                                      out_val=out))
            if func.is_view or name in free or ns == "prim":
                return out
            self.bytes += _nbytes(_tensors(args)) + _nbytes(_tensors(out))
            return out

        def cost(self) -> dict:
            return {"flops": self.flops, "bytes": self.bytes,
                    "coll": {k: tuple(v) for k, v in self.coll.items()}}

    return Counter()


def memory_tracker(counter):
    """``torch.distributed._tools.mem_tracker.MemTracker`` that skips the
    ops ``counter`` leaves uncounted (DTensor's sharding propagation on
    global-shaped fakes), so its peak is that of one rank's tensors."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if counter._quiet:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

        def peak_bytes(self) -> int:
            snap = self.get_tracker_snapshot("peak")
            return int(sum(v["Total"] for v in snap.values()))

    return Tracker()
