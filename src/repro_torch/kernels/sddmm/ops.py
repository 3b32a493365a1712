"""SDDMM on tensors: the two CUDA kernels' wrappers, their plain
versions, and the GAT attention entry points.

``sddmm_softmax_stats(pcsr, Q, K)`` is the front half of the GAT forward:
one pass returning the raw post-LeakyReLU logits in slot layout (masked
and padding slots −inf) and the per-row softmax stats ``rowmax`` /
``rowsum``, the operands the ParamSpMM softmax prologue
(``kernels.paramspmm.ops.paramspmm_with_vals(stats=...)``) consumes.
``sddmm_softmax`` materialises α from them (``normalize_from_stats``, from
``core.engine``, where both kernels' plain versions take it).

``sddmm(pcsr, Q, K)`` is the raw SDDMM, ``E = (A≠0) ⊙ (Q·Kᵀ)`` in slot
layout: the GAT backward's ``dα = SDDMM(pcsr, dOut, Vf)``.  Slots without
a stored nonzero (padding, coverage chunks, explicit zeros) are exactly 0.

Layouts.  Slot tensors are ``(C, V, K)`` over the *covered* steering (its
first ``pcsr.num_chunks`` chunks are the uncovered ones), or ``(H, C, V,
K)`` for ``(H, n, d)`` operands: heads are a grid axis over the
single-head steering.  Stats are dense float32 ``(n_blocks·R,)`` per head
— ``(H, n_blocks·R)`` for a head batch — and every row has them: ``−inf``
/ ``0`` for a row without a real edge.

``_stats_call`` and ``_call`` pick the implementation by the device of
``Q``: on a CPU tensor the plain version (``sddmm_softmax_plain``: gather
+ dot, ``scatter_reduce`` amax, ``index_add_`` of the exps in float64;
``sddmm_plain``: gather + dot on the real slots), on a CUDA tensor the
kernel in ``repro_torch/csrc/sddmm_softmax.cu`` or ``csrc/sddmm.cu``, or
an error.  Each kernel launch adds one to its ``launch_count(name)``.

``gat_backward(steer, src, logits, rowmax, rowsum, ...)`` is the GAT
backward's slot pass between the raw SDDMM (dα) and the three backward
SpMMs: α from the stats, the softmax vjp ``dx = α·(dα − rowdot[row])``,
``de = dx·scale·LeakyReLU'(logit)``, and the transfer of ``de`` and α onto
Aᵀ's covered slots through the int32 map ``src`` (A's covered flat slot of
each Aᵀ slot, −1 where it holds no edge, which reads 0).  On a CPU tensor
its plain version (``gat_backward_plain``), on a CUDA tensor one launch of
``csrc/gat_backward.cu``, bit-equal to it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.engine import _slot_rows, normalize_from_stats
from repro_torch.core.pcsr import PCSR
from repro_torch.kernels.paramspmm.ops import (Steering, SteeringArgs,
                                               check_steering,
                                               check_steering_args,
                                               device_steering,
                                               steering_args, vector_width)

# R ≤ 32 in both kernels: sddmm_softmax holds a block's row stats in one
# warp's lanes; sddmm's Q tile (R rows, d tiled to fit) is sized for it
MAX_R = 32

KERNELS = ("sddmm_softmax", "sddmm", "gat_backward")
_launches = dict.fromkeys(KERNELS, 0)


def launch_count(name: str = "sddmm_softmax") -> int:
    """Launches of kernel ``name`` (``"sddmm_softmax"``, ``"sddmm"`` or
    ``"gat_backward"``) since the last ``reset_launch_count()``."""
    return _launches[name]


def reset_launch_count() -> None:
    for name in KERNELS:
        _launches[name] = 0


def count_launches(name: str, n: int = 1) -> None:
    """Add ``n`` to ``launch_count(name)``: one per launch of the kernel,
    made by the wrapper or by a replay of a CUDA graph that captured it."""
    _launches[name] += n


def sddmm_plain(steer: Steering, Q, K_mat, *, V, R, K, n_rows):
    """The raw SDDMM kernel's plain PyTorch version, on any device:
    gather and dot on the real slots only.  ``Q`` is ``(H, n_rows, d)``,
    ``K_mat`` ``(H, ≥n_cols, d)``; returns ``(H, C, V, K)`` with every
    slot that holds no stored nonzero exactly 0."""
    H = Q.shape[0]
    C = steer.trow.shape[0]
    real = (steer.vals != 0).transpose(1, 2).reshape(C * K, V)
    idx = real.any(dim=1).nonzero()[:, 0]
    base = (steer.trow.long().repeat_interleave(K)[idx] * R
            + steer.lrow.long()[idx] * V)
    gathered = K_mat.index_select(1, steer.colidx.long()[idx])  # (H, S, d)
    x = Q.new_zeros((H, C * K, V))
    for v in range(V):                                        # V ≤ 2
        row = base + v
        inside = row < n_rows          # a real slot's row always is
        xv = (Q.index_select(1, torch.where(inside, row, 0))
              * gathered).sum(-1)
        x[:, idx, v] = torch.where(real[idx, v] & inside, xv, 0.0)
    return x.reshape(H, C, K, V).transpose(2, 3).contiguous()


def sddmm_softmax_plain(steer: Steering, Q, K_mat, *, V, R, K, n_blocks,
                        n_rows, scale: float, slope: float):
    """The kernel's plain PyTorch version, on any device.  ``Q`` is
    ``(H, n_rows, d)``, ``K_mat`` ``(H, ≥n_cols, d)``; returns logits
    ``(H, C, V, K)`` and stats ``(H, n_blocks·R)``."""
    H = Q.shape[0]
    x = sddmm_plain(steer, Q, K_mat, V=V, R=R, K=K, n_rows=n_rows) * scale
    x = torch.where(x >= 0, x, slope * x)                     # LeakyReLU
    # masked and padding slots are −inf whatever Q and K hold
    logits = torch.where(steer.vals != 0, x, -torch.inf)
    rows = _slot_rows(steer.lrow, steer.trow, V=V, R=R, K=K).reshape(-1)
    flat = logits.reshape(H, -1)
    rowmax = torch.full((H, n_blocks * R), -torch.inf, dtype=Q.dtype,
                        device=Q.device)
    rowmax = rowmax.scatter_reduce(1, rows.expand(H, -1), flat, "amax")
    # Σexp in float64, rounded once, so the check of the kernel (float32,
    # online per warp) sees the kernel's rounding only: a hub row sums
    # thousands of terms, and two float32 sums in other orders (this
    # index_add_ runs in no fixed order) differ by more than 1e-5 relative
    m = torch.where(torch.isfinite(rowmax), rowmax, 0.0).double()
    ex = torch.exp(flat.double() - m[:, rows])                 # −inf → 0
    heads = torch.arange(H, device=Q.device)[:, None] * (n_blocks * R)
    rowsum = ex.new_zeros(H * n_blocks * R).index_add_(
        0, (heads + rows).reshape(-1), ex.reshape(-1))
    return logits, rowmax, rowsum.to(Q.dtype).reshape(H, -1)


def _check_operands(steer, Q, K_mat, *, V, R, K, n_blocks, n_rows):
    check_steering(steer, V=V, R=R, K=K, n_blocks=n_blocks, n_rows=n_rows)
    if (Q.ndim not in (2, 3) or K_mat.ndim != Q.ndim
            or Q.shape[:-2] != K_mat.shape[:-2]
            or Q.shape[-1] != K_mat.shape[-1] or Q.shape[-2] != n_rows
            or K_mat.shape[-2] < steer.n_cols):
        raise ValueError(f"Q must be ([H,] {n_rows}, d) and K ([H,] "
                         f"≥{steer.n_cols}, d); got {tuple(Q.shape)} and "
                         f"{tuple(K_mat.shape)}")
    devices = {t.device for t in (steer.colidx, steer.vals, steer.groups,
                                  steer.units, Q, K_mat)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRY = {           # kernel → (C entry point, its argument types)
    "sddmm_softmax": ("repro_sddmm_softmax_f32",
                      [ctypes.POINTER(SteeringArgs), _P, _P, _P, _I, _P]
                      + [_I] * 7 + [_F, _F] + [_P] * 4),
    "sddmm": ("repro_sddmm_f32",
              [ctypes.POINTER(SteeringArgs), _P, _I, _P] + [_I] * 7
              + [_P, _P]),
    "gat_backward": ("repro_gat_backward_f32",
                     [_P] * 8 + [ctypes.c_longlong] * 2 + [_I] * 5
                     + [_F, _F] + [_P] * 5),
}
_LIBS: dict = {}


def _lib(name: str):
    """The shared library of kernel ``name``, built and bound on first
    use."""
    if name not in _LIBS:
        from repro_torch.kernels import build
        lib = build.load(name)
        fn_name, argtypes = _ENTRY[name]
        if name != "gat_backward":          # it takes no SteeringArgs
            check_steering_args(lib, name)
        if name == "sddmm_softmax":
            lib.repro_sddmm_sum_bytes.restype = ctypes.c_int
            # the Σexp type the library was built with (float32 as
            # shipped; float64 in chip_compare.py's variant)
            lib.sum_dtype = {4: torch.float32, 8: torch.float64}[
                lib.repro_sddmm_sum_bytes()]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _check_launch(kernel: str, steer: Steering, Q, K_mat, *, V, R):
    """Raise on anything the CUDA kernels do not take; returns the
    steering's ``SteeringArgs``."""
    if V not in (1, 2) or R > MAX_R:
        raise ValueError(f"CUDA {kernel} takes V ∈ {{1,2}}, R ≤ {MAX_R}; "
                         f"got V={V}, R={R}")
    args = steering_args(steer, kernel)
    for name, t, dtype in (("Q", Q, torch.float32),
                           ("K", K_mat, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"CUDA {kernel} takes {name} as {dtype}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"CUDA {kernel} needs a contiguous {name}")
    return args


def _stats_launch(steer: Steering, Q, K_mat, *, V, R, K, n_blocks, n_rows,
                  scale, slope):
    """Launch the fused SDDMM → softmax-stats kernel."""
    st = _check_launch("sddmm_softmax", steer, Q, K_mat, V=V, R=R)
    lead, d = tuple(Q.shape[:-2]), Q.shape[-1]
    H = Q.shape[0] if lead else 1
    C = int(steer.trow.shape[0])
    logits = torch.empty(lead + (C, V, K), dtype=torch.float32,
                         device=Q.device)
    rowmax = torch.empty(lead + (n_blocks * R,), dtype=torch.float32,
                         device=Q.device)
    rowsum = torch.empty_like(rowmax)
    if H == 0:
        return logits, rowmax, rowsum
    # split groups' partial (max, Σexp) pairs, merged in unit order
    lib = _lib("sddmm_softmax")
    part_max = part_sum = None
    if steer.n_partials:
        part_max = torch.empty((H, steer.n_partials, R), dtype=torch.float32,
                               device=Q.device)
        part_sum = torch.empty((H, steer.n_partials, R),
                               dtype=lib.sum_dtype, device=Q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        err = lib.repro_sddmm_softmax_f32(
            st, ptr(part_max), ptr(part_sum), ptr(Q), n_rows, ptr(K_mat),
            K_mat.shape[-2], d, H, V, R, K, vector_width(d, Q, K_mat),
            scale, slope, ptr(logits), ptr(rowmax), ptr(rowsum), stream)
    if err != 0:
        raise RuntimeError("sddmm_softmax kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    count_launches("sddmm_softmax")
    return logits, rowmax, rowsum


def _stats_call(steer: Steering, Q, K_mat, *, n_blocks, R, V, K, n_rows,
                scale: float, slope: float = 0.2):
    """Logits ``([H,] C, V, K)`` and stats ``([H,] n_blocks·R)`` for
    ``Q`` ``([H,] n_rows, d)`` and ``K_mat`` ``([H,] ≥n_cols, d)`` on
    pre-packed covered steering.  The plain version for a CPU ``Q``, the
    CUDA kernel for a CUDA ``Q``."""
    _check_operands(steer, Q, K_mat, V=V, R=R, K=K, n_blocks=n_blocks,
                    n_rows=n_rows)
    kw = dict(V=V, R=R, K=K, n_blocks=n_blocks, n_rows=n_rows,
              scale=float(scale), slope=float(slope))
    if Q.device.type == "cpu":
        if Q.ndim == 2:
            return tuple(t[0] for t in sddmm_softmax_plain(
                steer, Q[None], K_mat[None], **kw))
        return sddmm_softmax_plain(steer, Q, K_mat, **kw)
    if Q.device.type != "cuda":
        raise ValueError(f"sddmm_softmax runs on cpu or cuda, not "
                         f"{Q.device}")
    return _stats_launch(steer, Q, K_mat, **kw)


def sddmm_softmax_stats(pcsr: PCSR, Q, K, *, scale: float | None = None,
                        slope: float = 0.2):
    """The fused GAT attention front half, *stats form*: ``(logits,
    rowmax, rowsum)`` — raw post-LeakyReLU(``slope``) logits of
    ``scale·Q·Kᵀ`` on A's pattern (masked and padding slots −inf) and
    the per-row max and Σexp(logit − max).  ``scale`` defaults to 1/√d.
    ``(n, d)`` operands give ``(C, V, K)`` logits and ``(n_blocks·R,)``
    stats; ``(H, n, d)`` operands a leading head axis on each."""
    if scale is None:
        scale = float(1.0 / np.sqrt(Q.shape[-1]))
    cfg = pcsr.config
    return _stats_call(device_steering(pcsr, Q.device), Q, K,
                       n_blocks=pcsr.n_blocks, R=cfg.R, V=cfg.V, K=pcsr.K,
                       n_rows=pcsr.n_rows, scale=scale, slope=slope)


def sddmm_softmax(pcsr: PCSR, Q, K, *, scale: float | None = None,
                  slope: float = 0.2, with_logits: bool = False):
    """GAT attention weights softmax_row(LeakyReLU(scale·Q·Kᵀ)) on A's
    pattern, in covered slot layout: the *materialised-α* form (stats
    pass + one elementwise normalize).  The GAT path never runs it: the
    SpMM prologue takes the stats instead.  Returns ``alpha``, or
    ``(alpha, logits)`` with ``with_logits``: the post-LeakyReLU scores,
    masked slots −inf."""
    logits, rowmax, rowsum = sddmm_softmax_stats(pcsr, Q, K, scale=scale,
                                                 slope=slope)
    steer = device_steering(pcsr, Q.device)
    cfg = pcsr.config
    alpha = normalize_from_stats(logits, rowmax, rowsum, steer.lrow,
                                 steer.trow, R=cfg.R, V=cfg.V, K=pcsr.K)
    return (alpha, logits) if with_logits else alpha


def _launch(steer: Steering, Q, K_mat, *, V, R, K, n_rows):
    """Launch the raw SDDMM kernel."""
    st = _check_launch("sddmm", steer, Q, K_mat, V=V, R=R)
    lead, d = tuple(Q.shape[:-2]), Q.shape[-1]
    H = Q.shape[0] if lead else 1
    C = int(steer.trow.shape[0])
    out = torch.empty(lead + (C, V, K), dtype=torch.float32,
                      device=Q.device)
    if H == 0:
        return out
    lib = _lib("sddmm")
    ptr = lambda t: t.data_ptr()
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        err = lib.repro_sddmm_f32(
            st, ptr(Q), n_rows, ptr(K_mat), K_mat.shape[-2], d, H, V, R, K,
            vector_width(d, Q, K_mat), ptr(out), stream)
    if err != 0:
        raise RuntimeError("sddmm kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    count_launches("sddmm")
    return out


def _call(steer: Steering, Q, K_mat, *, n_blocks, R, V, K, n_rows):
    """Raw scores ``([H,] C, V, K)`` for ``Q`` ``([H,] n_rows, d)`` and
    ``K_mat`` ``([H,] ≥n_cols, d)`` on pre-packed covered steering.  The
    plain version for a CPU ``Q``, the CUDA kernel for a CUDA ``Q``."""
    _check_operands(steer, Q, K_mat, V=V, R=R, K=K, n_blocks=n_blocks,
                    n_rows=n_rows)
    kw = dict(V=V, R=R, K=K, n_rows=n_rows)
    if Q.device.type == "cpu":
        if Q.ndim == 2:
            return sddmm_plain(steer, Q[None], K_mat[None], **kw)[0]
        return sddmm_plain(steer, Q, K_mat, **kw)
    if Q.device.type != "cuda":
        raise ValueError(f"sddmm runs on cpu or cuda, not {Q.device}")
    return _launch(steer, Q, K_mat, **kw)


def sddmm(pcsr: PCSR, Q, K):
    """E = (A≠0) ⊙ (Q·Kᵀ) in covered slot layout: ``(n, d)`` operands
    give ``(C, V, K)``, ``(H, n, d)`` ones ``(H, C, V, K)``, every head in
    one launch.  ``Q`` has exactly ``pcsr.n_rows`` rows."""
    cfg = pcsr.config
    return _call(device_steering(pcsr, Q.device), Q, K,
                 n_blocks=pcsr.n_blocks, R=cfg.R, V=cfg.V, K=pcsr.K,
                 n_rows=pcsr.n_rows)


def slot_transfer(x, src, shape):
    """``x`` ``([H,] C, V, K)`` over A's covered slots, re-laid onto Aᵀ's
    covered slots ``shape``: slot t takes ``x``'s flat slot ``src[t]``,
    and exactly 0 where ``src[t]`` is −1 (no edge)."""
    lead = x.shape[:-3]
    flat = x.reshape(lead + (-1,)).index_select(-1, src.clamp_min(0).long())
    return torch.where(src >= 0, flat, 0.0).reshape(lead + tuple(shape))


def gat_backward_plain(steer: Steering, src, logits, rowmax, rowsum, *, R,
                       V, K, t_shape, scale: float, slope: float,
                       dalpha=None, rowdot=None, need_q=True, need_k=True,
                       need_v=True):
    """The slot pass's plain PyTorch version, on any device; returns
    ``(de, de_T, α_T)``, each None unless asked for."""
    alpha = normalize_from_stats(logits, rowmax, rowsum, steer.lrow,
                                 steer.trow, R=R, V=V, K=K)
    de = None
    if need_q or need_k:
        rows = _slot_rows(steer.lrow, steer.trow, V=V, R=R, K=K)
        dx = alpha * (dalpha - rowdot[..., rows])
        # LeakyReLU' from the saved logits: LeakyReLU keeps the sign, and
        # masked slots (−inf) have dx = 0, so their branch is inert
        de = dx * scale * torch.where(logits >= 0, 1.0, slope)
    return (de if need_q else None,
            slot_transfer(de, src, t_shape) if need_k else None,
            slot_transfer(alpha, src, t_shape) if need_v else None)


def _gat_backward_launch(steer: Steering, src, logits, rowmax, rowsum, *,
                         R, V, K, t_shape, scale, slope, dalpha, rowdot,
                         need_q, need_k, need_v):
    """Check the operands and launch the slot-pass kernel."""
    lead = tuple(logits.shape[:-3])
    H = lead[0] if lead else 1
    C = int(steer.trow.shape[0])
    n_seg = rowmax.shape[-1]
    t_shape = tuple(t_shape)
    n_a, n_t = C * V * K, int(np.prod(t_shape))
    need_dx = need_q or need_k
    shapes = [("logits", logits, lead + (C, V, K)),
              ("rowmax", rowmax, lead + (n_seg,)),
              ("rowsum", rowsum, lead + (n_seg,))]
    if need_dx:
        shapes += [("dalpha", dalpha, logits.shape),
                   ("rowdot", rowdot, rowmax.shape)]
    for name, t, shape in shapes:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"gat_backward: {name} must be {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"CUDA gat_backward takes {name} as contiguous "
                            f"float32, got {t.dtype}")
    for name, t in (("src", src), ("lrow", steer.lrow), ("trow", steer.trow)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"CUDA gat_backward takes {name} as contiguous "
                            f"int32, got {t.dtype}")
    if tuple(src.shape) != (n_t,):
        raise ValueError(f"gat_backward: src must be ({n_t},), got "
                         f"{tuple(src.shape)}")
    devices = {t.device for t in (logits, rowmax, rowsum, src, steer.lrow,
                                  steer.trow)}
    devices |= {t.device for t in (dalpha, rowdot) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    dev = logits.device
    empty = lambda shape: torch.empty(shape, dtype=torch.float32, device=dev)
    # dα is dead once the pass has read it (the kernel's second phase never
    # does), so its storage holds the first Aᵀ output where it fits
    spare = dalpha if need_dx else None

    def t_out():
        nonlocal spare
        if spare is not None and spare.numel() >= H * n_t:
            out, spare = spare.view(-1)[:H * n_t].view(lead + t_shape), None
            return out
        return empty(lead + t_shape)

    de = empty(logits.shape) if need_q else None
    de_t = t_out() if need_k else None
    alpha_t = t_out() if need_v else None
    n_p = int(need_k) + int(need_v)
    work = empty((n_a * H * n_p,)) if n_p else None
    if H == 0 or not (need_q or n_p):
        return de, de_t, alpha_t
    lib = _lib("gat_backward")
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_gat_backward_f32(
            ptr(logits), ptr(dalpha if need_dx else None), ptr(rowmax),
            ptr(rowsum), ptr(rowdot if need_dx else None), ptr(steer.lrow),
            ptr(steer.trow), ptr(src), n_a, n_t, H, V, K, R, n_seg,
            float(scale), float(slope), ptr(de), ptr(de_t), ptr(alpha_t),
            ptr(work), stream)
    if err != 0:
        raise RuntimeError("gat_backward kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    count_launches("gat_backward")
    return de, de_t, alpha_t


def gat_backward(steer: Steering, src, logits, rowmax, rowsum, *, R, V, K,
                 t_shape, scale: float = 1.0, slope: float = 0.2,
                 dalpha=None, rowdot=None, need_q=True, need_k=True,
                 need_v=True):
    """The GAT backward's slot pass over A's covered steering ``steer``:
    ``(de, de_T, α_T)``, each None unless asked for (``need_q``: ``de`` in
    A's layout, ``need_k``: ``de_T`` and ``need_v``: ``α_T`` on Aᵀ's
    covered slots ``t_shape``).  ``logits`` are the forward's ``([H,] C,
    V, K)``, the stats ``([H,] n_blocks·R)``; ``de`` needs ``dalpha`` (the
    raw SDDMM's dα, ``logits``' shape) and ``rowdot`` (dOut·out per row,
    the stats' shape).  ``src`` is ``TransposeSide.src``.  The plain
    version for CPU tensors, one launch of the CUDA kernel for CUDA ones,
    which may return an Aᵀ output in ``dalpha``'s storage: the caller
    passes a dα it does not read again."""
    if (need_q or need_k) and (dalpha is None or rowdot is None):
        raise ValueError("gat_backward: de needs dalpha and rowdot")
    kw = dict(R=R, V=V, K=K, t_shape=t_shape, scale=scale, slope=slope,
              dalpha=dalpha, rowdot=rowdot, need_q=need_q, need_k=need_k,
              need_v=need_v)
    if logits.device.type == "cpu":
        return gat_backward_plain(steer, src, logits, rowmax, rowsum, **kw)
    if logits.device.type != "cuda":
        raise ValueError(f"gat_backward runs on cpu or cuda, not "
                         f"{logits.device}")
    return _gat_backward_launch(steer, src, logits, rowmax, rowsum, **kw)
