"""ParamSpMM on tensors: the CUDA kernel's wrapper, its plain version, and
the ``paramspmm(pcsr, B)`` / ``paramspmm_with_vals(pcsr, vals, B,
stats=)`` entry points.

Dispatch goes through *covered* steering arrays
(``PCSR.steering(covered=True)``): every output block, empty ones
included, is one chunk group, so the kernel zeroes it and runs the fused
epilogue (per-row scale, per-feature bias, dense residual, activation) on
it.  ``Steering`` carries those arrays on a device together with the
group table and the *work-unit* table the kernels are launched over
(``work_units``: contiguous slot ranges of at most ``cap`` real slots
inside one group, so a hub group spreads over many thread blocks whose
partial tiles are summed in unit order).  With softmax stats the kernel
runs the GAT *prologue* instead: the slot values are logits and each slot
weight is α = exp(logit − rowmax)/rowsum, computed once per slot.

A serving bucket launches every batch over one grid: ``schedule_bounds``
gives the largest unit table any steering of a fixed geometry can have
(at a cap fixed by the geometry), and ``Steering.from_pcsr(bounds=)``
pads each batch's table to it with empty units and empty splits, which
the kernels skip.  A table past a bound raises.

``_call`` picks the implementation by the device of ``B``: on a CPU
tensor the plain version (``paramspmm_plain``: the engine's gather +
``index_add_`` plus ``apply_epilogue``), on a CUDA tensor the kernel in
``repro_torch/csrc/paramspmm.cu`` or an error.  Each call that launches
adds one to ``launch_count()`` (the merge of split groups runs inside the
same C entry point).
"""
from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.engine import (_engine, apply_epilogue,
                                     normalize_from_stats)
from repro_torch.core.pcsr import PCSR

ACTIVATIONS = ("none", "relu", "leaky_relu")
_ACT_CODE = {"none": 0, "relu": 1, "leaky_relu": 2}
MAX_R = 32            # (R, Dblk) tile ≤ 32 × 512 float32 = 64 KB smem
MAX_DBLK = 512        # F ≤ 4
LEAKY_SLOPE = 0.2     # leaky_relu's negative slope, as in the reference
UNIT_MIN_CAP = 256    # real slots a work unit may always hold

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count()``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def count_launches(n: int = 1) -> None:
    """Add ``n`` to ``launch_count()``: one per launch of the kernel, made
    by the wrapper or by a replay of a CUDA graph that captured it
    (``kernels.capture``; a capture itself launches nothing)."""
    global _launches
    _launches += n


def group_table(trow: np.ndarray, init: np.ndarray, fini: np.ndarray,
                n_blocks: int) -> np.ndarray:
    """``(n_groups + 1,)`` int32 chunk offsets of the chunk groups of a
    covered steering: group g is chunks ``[t[g], t[g+1])``, opened by an
    ``init = 1`` chunk and closed by a ``fini = 1`` chunk, all with one
    ``trow``.  Raises unless every block is exactly one group — two thread
    blocks writing one output block would race, and a block without a
    group would never be written."""
    C = int(trow.shape[0])
    starts = np.flatnonzero(init)
    ends = np.flatnonzero(fini) + 1
    ok = (starts.size == ends.size == n_blocks and C > 0
          and starts[0] == 0 and ends[-1] == C
          and np.array_equal(starts[1:], ends[:-1]))
    if ok:
        heads = trow[starts]
        ok = (np.array_equal(np.repeat(heads, ends - starts), trow)
              and np.array_equal(np.sort(heads), np.arange(n_blocks)))
    if not ok:
        raise ValueError("steering is not one contiguous init…fini chunk "
                         "group per output block (pass covered steering)")
    return np.concatenate([starts, [C]]).astype(np.int32)


def unit_cap(real_per_group: np.ndarray) -> int:
    """The wrapper's cap on real slots per work unit, from the pack: twice
    the mean real slots of a non-empty chunk group, and at least
    ``UNIT_MIN_CAP``.  Typical groups stay whole; a hub group (a
    power-law graph's, tens of times the mean) is cut into many units."""
    nz = real_per_group[real_per_group > 0]
    mean = -(-int(nz.sum()) // int(nz.size)) if nz.size else 0
    return max(UNIT_MIN_CAP, 2 * mean)


def work_units(vals: np.ndarray, groups: np.ndarray, K: int,
               cap: int | None = None):
    """The work schedule of a covered steering, built on the host.

    A *unit* is a contiguous slot range ``[begin, end)`` (flat slot
    indices ``c·K + k``) inside one chunk group, holding at most ``cap``
    real slots (slots whose stored ``vals`` are not all 0).  Units are cut
    at chunk boundaries, and inside a chunk only where that chunk alone
    holds more than ``cap`` real slots.  A group with at most ``cap`` real
    slots is one unit, which the kernels write directly with the epilogue
    fused.  The units of a *split* group each write a partial into a
    workspace, at consecutive indices; a merge step sums them in unit
    order.

    Returns ``(units, splits, n_partials, cap, most, span)``: ``units``
    ``(U, 4)`` int32 rows ``[begin, end, group, partial]`` in group order
    (``partial`` −1 for a group that is one unit), ``splits`` ``(S, 3)``
    int32 rows ``[group, first partial, end partial]`` of the split
    groups, ``most`` the largest number of real slots in a unit and
    ``span`` the most slots a unit covers."""
    C = int(groups[-1])
    if C * K > np.iinfo(np.int32).max:
        raise ValueError(f"{C}×{K} slots exceed the int32 unit table")
    real = (np.asarray(vals) != 0).any(axis=1).reshape(-1)      # (C·K,)
    cum = np.concatenate([[0], np.cumsum(real, dtype=np.int64)])
    g_slot = groups.astype(np.int64) * K
    per_group = cum[g_slot[1:]] - cum[g_slot[:-1]]
    cap = unit_cap(per_group) if cap is None else int(cap)
    if cap < 1:
        raise ValueError(f"unit cap must be ≥ 1, got {cap}")
    # one unit per group, then each group over the cap replaced by its cuts
    whole = np.stack([g_slot[:-1], g_slot[1:], np.arange(len(per_group)),
                      np.full(len(per_group), -1)], axis=1)
    pieces, splits, n_partials, prev = [], [], 0, 0
    for g in np.flatnonzero(per_group > cap):
        b0, b1 = int(g_slot[g]), int(g_slot[g + 1])
        # cut candidates: chunk starts, plus the slot of every cap-th real
        # slot inside a chunk that alone holds more than cap
        cand = [b0]
        for c in range(int(groups[g]), int(groups[g + 1])):
            s0 = c * K
            if s0 > b0:
                cand.append(s0)
            if cum[s0 + K] - cum[s0] > cap:
                pos = s0 + np.flatnonzero(real[s0:s0 + K])
                cand.extend(int(x) for x in pos[cap::cap])
        cand.append(b1)
        cand = np.asarray(cand, np.int64)
        cr = cum[cand]
        rows, p0, i = [], n_partials, 0
        while i < len(cand) - 1:
            # the farthest candidate within cap real slots of cand[i]
            j = int(np.searchsorted(cr, cr[i] + cap, side="right")) - 1
            j = max(j, i + 1)
            rows.append((cand[i], cand[j], g, n_partials))
            n_partials += 1
            i = j
        pieces += [whole[prev:g], np.asarray(rows, np.int64)]
        splits.append((g, p0, n_partials))
        prev = g + 1
    pieces.append(whole[prev:])
    rows = np.concatenate(pieces)
    units = rows.astype(np.int32)
    most = int((cum[units[:, 1]] - cum[units[:, 0]]).max())
    span = int((units[:, 1] - units[:, 0]).max())
    return (units, np.asarray(splits, np.int32).reshape(-1, 3), n_partials,
            cap, most, span)


@dataclass(frozen=True)
class ScheduleBounds:
    """The largest work-unit table (``work_units`` at ``cap``) of any
    covered steering of one fixed geometry: table rows, partials, and the
    ``most`` / ``span`` the kernels size their blocks by."""

    cap: int
    n_units: int
    n_splits: int
    n_partials: int
    most: int
    span: int


def schedule_bounds(n_blocks: int, num_chunks: int, K: int,
                    cap: int | None = None) -> ScheduleBounds:
    """Bounds of the unit table of every steering with ``n_blocks`` chunk
    groups over ``num_chunks`` chunks of ``K`` slots, each block at least
    one chunk (a serving bucket's ``PackGeom``).

    The real slots are taken to be at most ``E = (num_chunks −
    n_blocks)·K``: ``PackGeom.from_bucket`` sizes ``num_chunks`` so that E
    is at least the bucket's edge ceiling, and a batch in the bucket has
    no more edges than that (``_pad_schedule`` checks the table itself,
    whatever the batch).  ``cap`` defaults to the wrapper's rule at
    that ceiling: ``max(UNIT_MIN_CAP, 2K)`` (K is the mean slots of a
    full block).  Two consecutive units of a split group hold more than
    ``cap`` real slots together (the cut is greedy), so a split group of
    r real slots has at most ``2⌊r/(cap+1)⌋ + 1`` units; with ``F =
    ⌊E/(cap+1)⌋`` there are at most F split groups, 3F partials and
    ``n_blocks + 2F`` units (``n_blocks − splits + partials``, as
    ``check_steering`` asks).  No unit holds more than ``min(cap, E)``
    real slots or spans more than a group can, ``(num_chunks − n_blocks
    + 1)·K`` slots."""
    edges = (num_chunks - n_blocks) * K
    if n_blocks < 1 or edges < 0:
        raise ValueError(f"no geometry has {n_blocks} blocks in "
                         f"{num_chunks} chunks")
    cap = max(UNIT_MIN_CAP, 2 * K) if cap is None else int(cap)
    if cap < 1:
        raise ValueError(f"unit cap must be ≥ 1, got {cap}")
    f = edges // (cap + 1)
    return ScheduleBounds(cap=cap, n_units=n_blocks + 2 * f, n_splits=f,
                          n_partials=3 * f, most=max(1, min(cap, edges)),
                          span=(num_chunks - n_blocks + 1) * K)


def _pad_schedule(units: np.ndarray, splits: np.ndarray, n_partials: int,
                 most: int, span: int, bounds: ScheduleBounds,
                 n_slots: int):
    """``units`` and ``splits`` padded to ``bounds``: empty units ``[n_slots,
    n_slots, −1, −1]`` after the real ones (the begins stay sorted) and
    empty splits ``[0, 0, 0]``, both of which the kernels skip.  Raises
    if the table exceeds a bound: a serving bucket's grid is fixed, and a
    larger table would need another one."""
    over = [f"{name} {got} > {bound}" for name, got, bound in (
        ("units", len(units), bounds.n_units),
        ("split groups", len(splits), bounds.n_splits),
        ("partials", n_partials, bounds.n_partials),
        ("real slots in a unit", most, bounds.most),
        ("slots in a unit", span, bounds.span))
        if got > bound]
    if over:
        raise ValueError("the work schedule exceeds its bucket's bounds: "
                         + ", ".join(over))
    pad_u = np.tile(np.array([[n_slots, n_slots, -1, -1]], np.int32),
                    (bounds.n_units - len(units), 1))
    pad_s = np.zeros((bounds.n_splits - len(splits), 3), np.int32)
    return (np.concatenate([units, pad_u]).astype(np.int32),
            np.concatenate([splits, pad_s]).astype(np.int32))


def host_steering(pcsr: PCSR, *, cap: int | None = None,
                  bounds: ScheduleBounds | None = None) -> dict:
    """The fields of ``Steering.from_pcsr`` on the host: numpy arrays and
    sizes.  With ``bounds`` the unit table is cut at ``bounds.cap`` and
    padded to the bounds, and the sizes are the bounds'."""
    st = pcsr.steering(covered=True)
    if st["colidx"].size and int(st["colidx"].max()) >= pcsr.n_cols:
        raise ValueError("colidx out of range of the packed matrix")
    groups = group_table(st["trow"], st["init"], st["fini"], pcsr.n_blocks)
    if bounds is not None:
        cap = bounds.cap
    units, splits, n_partials, cap, most, span = work_units(
        st["vals"], groups, pcsr.K, cap)
    # the merges write a split group's output block: name it, so the
    # kernels need neither the group table nor trow to find it
    splits = splits.copy()
    splits[:, 0] = st["trow"][groups[splits[:, 0]]]
    if bounds is not None:
        units, splits = _pad_schedule(units, splits, n_partials, most,
                                      span, bounds,
                                      int(st["trow"].size) * pcsr.K)
        n_partials, most, span = (bounds.n_partials, bounds.most,
                                  bounds.span)
    return dict(colidx=st["colidx"], lrow=st["lrow"], trow=st["trow"],
                vals=st["vals"], groups=groups, units=units, splits=splits,
                n_partials=n_partials, cap=cap, most=most, span=span,
                n_cols=pcsr.n_cols)


@dataclass(frozen=True, eq=False)
class Steering:
    """Covered steering arrays of one PCSR on one device, plus the group
    table and the work-unit table the kernels are launched over (both
    built on the host, once per pack).  Compared by identity: its
    ``SteeringArgs`` are cached per instance."""

    colidx: torch.Tensor   # (C·K,) int32
    lrow: torch.Tensor     # (C·K,) int32
    trow: torch.Tensor     # (C,)   int32
    vals: torch.Tensor     # (C, V, K) float32
    groups: torch.Tensor   # (n_groups + 1,) int32
    units: torch.Tensor    # (U, 4) int32: begin, end, group, partial
    splits: torch.Tensor   # (S, 3) int32: output block, first, end partial
    n_partials: int        # units of split groups
    cap: int               # real slots per unit at most
    most: int              # real slots of the fullest unit
    span: int              # slots of the longest unit
    n_cols: int            # colidx < n_cols (checked on the host)

    @property
    def n_groups(self) -> int:
        return int(self.groups.shape[0]) - 1

    @property
    def n_units(self) -> int:
        return int(self.units.shape[0])

    @staticmethod
    def from_pcsr(pcsr: PCSR, device, *, cap: int | None = None,
                  bounds: ScheduleBounds | None = None) -> "Steering":
        """``cap`` overrides ``unit_cap`` (tests force the split path);
        ``bounds`` pads the unit table to a fixed geometry's bounds
        (``host_steering``)."""
        return Steering(**{
            k: torch.as_tensor(v, device=device)
            if isinstance(v, np.ndarray) else v
            for k, v in host_steering(pcsr, cap=cap, bounds=bounds).items()})


def device_steering(pcsr: PCSR, device) -> Steering:
    """``Steering.from_pcsr`` cached on the PCSR per device ("cuda" and
    the current "cuda:N" share one copy)."""
    cache = pcsr.__dict__.setdefault("_device_steering", {})
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    if key not in cache:
        cache[key] = Steering.from_pcsr(pcsr, dev)
    return cache[key]


def paramspmm_plain(steer: Steering, B, *, V, R, K, n_blocks, n_rows,
                    vals=None, rowmax=None, rowsum=None, scale=None,
                    bias=None, residual=None, activation: str = "none"):
    """The kernel's plain PyTorch version, on any device: the engine's
    gather + ``index_add_`` then ``apply_epilogue``.  ``vals`` overrides
    the stored slot values; with ``rowmax``/``rowsum`` they are logits
    and the prologue is ``normalize_from_stats``.  ``B`` of shape
    ``(H, n, d)`` (with ``vals`` ``(H, C, V, K)`` and stats
    ``(H, n_blocks·R)``) runs each head over the same steering."""
    vals = steer.vals if vals is None else vals
    if rowmax is not None:
        vals = normalize_from_stats(vals, rowmax, rowsum, steer.lrow,
                                    steer.trow, R=R, V=V, K=K)
    run = lambda v, b: _engine(steer.colidx, steer.lrow, steer.trow, v, b,
                               V=V, R=R, K=K, n_blocks=n_blocks,
                               n_rows=n_rows)
    if B.ndim == 3:
        return torch.stack([run(vals[h], B[h]) for h in range(B.shape[0])])
    return apply_epilogue(run(vals, B), scale, bias, activation,
                          LEAKY_SLOPE, residual)


def check_steering(steer: Steering, *, V, R, K, n_blocks, n_rows):
    """Raise unless ``steer`` has the geometry's shapes: one chunk group
    per output block, and a unit table that tiles every slot."""
    C = int(steer.trow.shape[0])
    if (tuple(steer.vals.shape) != (C, V, K)
            or steer.colidx.shape[0] != C * K or steer.n_groups != n_blocks
            or n_rows > n_blocks * R):
        raise ValueError("steering arrays do not match the geometry "
                         f"(C={C}, V={V}, K={K}, n_blocks={n_blocks}, "
                         f"R={R}, n_rows={n_rows})")
    n_splits = int(steer.splits.shape[0])
    if (tuple(steer.units.shape[1:]) != (4,)
            or tuple(steer.splits.shape[1:]) != (3,)
            or steer.n_units != steer.n_groups - n_splits + steer.n_partials):
        raise ValueError(f"unit table ({steer.n_units} units, "
                         f"{steer.n_partials} partials) does not match "
                         f"{steer.n_groups} chunk groups")


def vector_width(dim: int, *tensors) -> int:
    """The widest load (4, 2 or 1 floats) that ``dim`` and the addresses
    of ``tensors`` allow."""
    for w in (4, 2):
        if dim % w == 0 and all(t.data_ptr() % (4 * w) == 0
                                for t in tensors):
            return w
    return 1


class SteeringArgs(ctypes.Structure):
    """A steering's device arrays and sizes as the C entry points of
    ``csrc/paramspmm.cu``, ``csrc/sddmm_softmax.cu`` and ``csrc/sddmm.cu``
    take them (``csrc/steering.h``, the same fields in order): one pointer
    a call in place of thirteen arguments."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "colidx", "lrow", "trow", "vals", "units", "splits")] + [
        (name, ctypes.c_int) for name in (
            "n_blocks", "n_chunks", "n_units", "n_splits", "n_partials",
            "most", "span")]


def check_steering_args(lib, kernel: str) -> None:
    """Raise unless ``lib``'s ``SteeringArgs`` has the ctypes struct's
    size (a field added or dropped on one side only)."""
    lib.repro_steering_args_size.argtypes = []
    lib.repro_steering_args_size.restype = ctypes.c_int
    size = lib.repro_steering_args_size()
    if size != ctypes.sizeof(SteeringArgs):
        raise RuntimeError(f"{kernel}: csrc/steering.h's SteeringArgs is "
                           f"{size} bytes, ops.SteeringArgs "
                           f"{ctypes.sizeof(SteeringArgs)}")


_STEERING_ARGS: "weakref.WeakKeyDictionary[Steering, SteeringArgs]" = \
    weakref.WeakKeyDictionary()


def steering_args(steer: Steering, kernel: str) -> SteeringArgs:
    """``steer``'s ``SteeringArgs``, its arrays' types and layout checked
    and the struct built on first use, then cached while ``steer``
    lives."""
    args = _STEERING_ARGS.get(steer)
    if args is None:
        for name in ("colidx", "lrow", "trow", "units", "splits", "vals"):
            t = getattr(steer, name)
            dtype = torch.float32 if name == "vals" else torch.int32
            if t.dtype != dtype:
                raise TypeError(f"CUDA {kernel} takes {name} as {dtype}, "
                                f"got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"CUDA {kernel} needs a contiguous {name}")
        args = SteeringArgs(
            *(getattr(steer, k).data_ptr() for k in (
                "colidx", "lrow", "trow", "vals", "units", "splits")),
            steer.n_groups, int(steer.trow.shape[0]), steer.n_units,
            int(steer.splits.shape[0]), steer.n_partials, steer.most,
            steer.span)
        _STEERING_ARGS[steer] = args
    return args


def _check_operands(steer, B, vals, rowmax, rowsum, scale, bias, residual,
                    *, V, R, K, n_blocks, n_rows, activation):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
    check_steering(steer, V=V, R=R, K=K, n_blocks=n_blocks, n_rows=n_rows)
    C = int(steer.trow.shape[0])
    if B.ndim not in (2, 3) or B.shape[-2] < steer.n_cols:
        raise ValueError(f"B must be (≥{steer.n_cols}, dim) or (H, "
                         f"≥{steer.n_cols}, dim), got {tuple(B.shape)}")
    lead = tuple(B.shape[:-2])
    if B.ndim == 3 and (scale is not None or bias is not None
                        or residual is not None or activation != "none"):
        raise NotImplementedError("epilogue fusion is single-head")
    if B.ndim == 3 and vals is None:
        raise ValueError("a head batch needs per-head vals (H, C, V, K)")
    if vals is not None and tuple(vals.shape) != lead + (C, V, K):
        raise ValueError(f"vals must be {lead + (C, V, K)} (covered "
                         f"layout), got {tuple(vals.shape)}")
    if (rowmax is None) != (rowsum is None):
        raise ValueError("the softmax prologue needs both rowmax and rowsum")
    if rowmax is not None:
        if vals is None:
            # the prologue reads vals as logits; the stored edge values
            # (and the 0-valued coverage chunks) are not logits
            raise ValueError("stats= requires explicit logits as vals "
                             "(from sddmm_softmax_stats), not the stored "
                             "PCSR values")
        for name, t in (("rowmax", rowmax), ("rowsum", rowsum)):
            if tuple(t.shape) != lead + (n_blocks * R,):
                raise ValueError(f"{name} must be {lead + (n_blocks * R,)}, "
                                 f"got {tuple(t.shape)}")
    dim = B.shape[-1]
    for name, t, shape in (("scale", scale, (n_rows,)),
                           ("bias", bias, (dim,)),
                           ("residual", residual, (n_rows, dim))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    devices = {t.device for t in (steer.colidx, steer.vals, steer.groups,
                                  steer.units, B, vals, rowmax, rowsum,
                                  scale, bias, residual) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load("paramspmm")
        check_steering_args(lib, "paramspmm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_paramspmm_f32.argtypes = [
            ctypes.POINTER(SteeringArgs), p, p, p, i, i, p, p, p, p, p, p,
            i, i, i, i, i, i, i, i, ctypes.c_float, p]
        lib.repro_paramspmm_f32.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(steer: Steering, B, *, V, R, K, dblk, n_rows, vals, rowmax,
            rowsum, scale, bias, residual, activation):
    """Launch the CUDA kernel on ``B`` ``([H,] n, dim)``, ``vals``
    ``([H,] C, V, K)`` and stats ``([H,] n_blocks·R)`` or None; raises on
    anything it does not take."""
    if V not in (1, 2) or R > MAX_R or dblk > MAX_DBLK:
        raise ValueError(f"CUDA paramspmm takes V ∈ {{1,2}}, R ≤ {MAX_R}, "
                         f"Dblk ≤ {MAX_DBLK}; got V={V}, R={R}, Dblk={dblk}")
    lead, (b_rows, dim) = tuple(B.shape[:-2]), B.shape[-2:]
    H = B.shape[0] if lead else 1
    st = steering_args(steer, "paramspmm")
    for name, t, dtype in (
            ("vals", vals, torch.float32), ("B", B, torch.float32),
            ("rowmax", rowmax, torch.float32),
            ("rowsum", rowsum, torch.float32),
            ("scale", scale, torch.float32), ("bias", bias, torch.float32),
            ("residual", residual, torch.float32)):
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"CUDA paramspmm takes {name} as {dtype}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"CUDA paramspmm needs a contiguous {name}")
    out = torch.empty(lead + (n_rows, dim), dtype=torch.float32,
                      device=B.device)
    if n_rows == 0 or dim == 0 or H == 0:
        return out
    # split groups' partial tiles: the design's workspace, summed in unit
    # order by the merge step
    partial = (torch.empty((H, steer.n_partials, R, dim),
                           dtype=torch.float32, device=B.device)
               if steer.n_partials else None)
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = lib.repro_paramspmm_f32(
            st, ptr(vals), ptr(partial), ptr(B), b_rows, dim, ptr(rowmax),
            ptr(rowsum), ptr(scale), ptr(bias), ptr(residual), ptr(out),
            n_rows, H, V, R, K, dblk, vector_width(dim, B),
            _ACT_CODE[activation], LEAKY_SLOPE, stream)
    if err != 0:
        raise RuntimeError("paramspmm kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    count_launches()
    return out


def _call(steer: Steering, B, *, n_blocks, R, V, K, dblk, n_rows,
          vals=None, rowmax=None, rowsum=None, scale=None, bias=None,
          residual=None, activation: str = "none"):
    """act(scale ⊙ (A·B) + bias + residual) on pre-packed covered
    steering, shapes ``scale (n_rows,)``, ``bias (dim,)``, ``residual
    (n_rows, dim)``.  ``vals`` (covered ``(C, V, K)``) overrides the
    stored slot values; ``rowmax``/``rowsum`` (``(n_blocks·R,)``) turn
    on the softmax prologue, ``vals`` then being logits.  A ``(H, n,
    dim)`` ``B`` takes ``(H, C, V, K)`` vals and ``(H, n_blocks·R)``
    stats and returns ``(H, n_rows, dim)`` (no epilogue).  The plain
    version for a CPU ``B``, the CUDA kernel for a CUDA ``B``."""
    _check_operands(steer, B, vals, rowmax, rowsum, scale, bias, residual,
                    V=V, R=R, K=K, n_blocks=n_blocks, n_rows=n_rows,
                    activation=activation)
    if B.device.type == "cpu":
        return paramspmm_plain(steer, B, V=V, R=R, K=K, n_blocks=n_blocks,
                               n_rows=n_rows, vals=vals, rowmax=rowmax,
                               rowsum=rowsum, scale=scale, bias=bias,
                               residual=residual, activation=activation)
    if B.device.type != "cuda":
        raise ValueError(f"paramspmm runs on cpu or cuda, not {B.device}")
    return _launch(steer, B, V=V, R=R, K=K, dblk=dblk, n_rows=n_rows,
                   vals=steer.vals if vals is None else vals, rowmax=rowmax,
                   rowsum=rowsum, scale=scale, bias=bias, residual=residual,
                   activation=activation)


def paramspmm(pcsr: PCSR, B, *, scale=None, bias=None, residual=None,
              activation: str = "none"):
    """C = act(scale ⊙ (A·B) + bias + residual) where A is held as PCSR —
    the epilogue operands default to the identity (plain A·B)."""
    return paramspmm_with_vals(pcsr, None, B, scale=scale, bias=bias,
                               residual=residual, activation=activation)


def paramspmm_with_vals(pcsr: PCSR, vals, B, *, stats=None, scale=None,
                        bias=None, residual=None, activation: str = "none"):
    """SpMM over A's *pattern* with per-slot values supplied at call time
    (``vals=None``: the values stored in the PCSR) — the aggregation step
    of attention GNNs.

    ``stats=(rowmax, rowsum)`` turns on the softmax **prologue**: ``vals``
    are then the logits of ``sddmm_softmax_stats`` in the covered layout
    (masked, padding and coverage slots −inf) and α = exp(logit −
    rowmax)/rowsum is computed in the kernel, never written out.

    The epilogue (``scale``/``bias``/``residual``/``activation``) is
    single-head.  Multi-head: ``vals`` ``(H, C, V, K)``, ``B``
    ``(H, n, d)`` and stats ``(H, n_blocks·R)`` run every head in one
    launch and return ``(H, n_rows, d)``.
    """
    cfg = pcsr.config
    rowmax, rowsum = stats if stats is not None else (None, None)
    return _call(device_steering(pcsr, B.device), B, n_blocks=pcsr.n_blocks,
                 R=cfg.R, V=cfg.V, K=pcsr.K, dblk=cfg.dblk,
                 n_rows=pcsr.n_rows, vals=vals, rowmax=rowmax,
                 rowsum=rowsum, scale=scale, bias=bias, residual=residual,
                 activation=activation)
