"""ParamSpMM on tensors: the CUDA kernel's wrapper, its plain version, and
the ``paramspmm(pcsr, B)`` / ``paramspmm_with_vals(pcsr, vals, B,
stats=)`` entry points.

Dispatch goes through *covered* steering arrays
(``PCSR.steering(covered=True)``): every output block, empty ones
included, is one chunk group, so the kernel zeroes it and runs the fused
epilogue (per-row scale, per-feature bias, dense residual, activation) on
it.  ``Steering`` carries those arrays on a device together with the
group table the kernel is launched over.  With softmax stats the kernel
runs the GAT *prologue* instead: the slot values are logits and each slot
weight is α = exp(logit − rowmax)/rowsum, computed in registers.

``_call`` picks the implementation by the device of ``B``: on a CPU
tensor the plain version (``paramspmm_plain``: the engine's gather +
``index_add_`` plus ``apply_epilogue``), on a CUDA tensor the kernel in
``repro_torch/csrc/paramspmm.cu`` or an error.  Each kernel launch adds
one to ``launch_count()``.
"""
from __future__ import annotations

import ctypes
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

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count()``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


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


@dataclass(frozen=True)
class Steering:
    """Covered steering arrays of one PCSR on one device, plus the group
    table the kernel is launched over (built on the host, once per pack)."""

    colidx: torch.Tensor   # (C·K,) int32
    lrow: torch.Tensor     # (C·K,) int32
    trow: torch.Tensor     # (C,)   int32
    vals: torch.Tensor     # (C, V, K) float32
    groups: torch.Tensor   # (n_groups + 1,) int32
    n_cols: int            # colidx < n_cols (checked on the host)

    @property
    def n_groups(self) -> int:
        return int(self.groups.shape[0]) - 1

    @staticmethod
    def from_pcsr(pcsr: PCSR, device) -> "Steering":
        st = pcsr.steering(covered=True)
        if st["colidx"].size and int(st["colidx"].max()) >= pcsr.n_cols:
            raise ValueError("colidx out of range of the packed matrix")
        groups = group_table(st["trow"], st["init"], st["fini"],
                             pcsr.n_blocks)
        dev = {k: torch.as_tensor(st[k], device=device)
               for k in ("colidx", "lrow", "trow", "vals")}
        return Steering(groups=torch.as_tensor(groups, device=device),
                        n_cols=pcsr.n_cols, **dev)


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


def _check_operands(steer, B, vals, rowmax, rowsum, scale, bias, residual,
                    *, V, R, K, n_blocks, n_rows, activation):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
    C = int(steer.trow.shape[0])
    if (tuple(steer.vals.shape) != (C, V, K)
            or steer.colidx.shape[0] != C * K or steer.n_groups != n_blocks
            or n_rows > n_blocks * R):
        raise ValueError("steering arrays do not match the geometry "
                         f"(C={C}, V={V}, K={K}, n_blocks={n_blocks}, "
                         f"R={R}, n_rows={n_rows})")
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
    devices = {t.device for t in (steer.colidx, steer.vals, steer.groups, B,
                                  vals, rowmax, rowsum, scale, bias,
                                  residual) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load("paramspmm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_paramspmm_f32.argtypes = [
            p, p, p, p, p, i, i, p, i, i, p, p, p, p, p, p, i, i, i, i, i,
            i, i, ctypes.c_float, p]
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
    global _launches
    if V not in (1, 2) or R > MAX_R or dblk > MAX_DBLK:
        raise ValueError(f"CUDA paramspmm takes V ∈ {{1,2}}, R ≤ {MAX_R}, "
                         f"Dblk ≤ {MAX_DBLK}; got V={V}, R={R}, Dblk={dblk}")
    lead, (b_rows, dim) = tuple(B.shape[:-2]), B.shape[-2:]
    H = B.shape[0] if lead else 1
    for name, t, dtype in (
            ("colidx", steer.colidx, torch.int32),
            ("lrow", steer.lrow, torch.int32),
            ("trow", steer.trow, torch.int32),
            ("groups", steer.groups, torch.int32),
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
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = lib.repro_paramspmm_f32(
            ptr(steer.colidx), ptr(steer.lrow), ptr(steer.trow), ptr(vals),
            ptr(steer.groups), steer.n_groups, int(steer.trow.shape[0]),
            ptr(B), b_rows, dim, ptr(rowmax), ptr(rowsum), ptr(scale),
            ptr(bias), ptr(residual), ptr(out), n_rows, H, V, R, K, dblk,
            _ACT_CODE[activation], LEAKY_SLOPE, stream)
    if err != 0:
        raise RuntimeError("paramspmm kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    _launches += 1
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
