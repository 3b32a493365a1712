"""The selective scan on tensors: the CUDA kernel's wrapper.

``selective_scan(dA, dBx, C)`` takes the JAX package's signature and
shapes (``repro/kernels/selective_scan/ops.py``): dA/dBx ``(B, S, N,
Di)``, C ``(B, S, N)`` → y ``(B, S, Di)`` float32, every operand cast to
float32 first.  It picks the implementation by the device of ``dA``: on a
CPU tensor the plain version (``ref.selective_scan_plain``), on a CUDA
tensor the kernel in ``repro_torch/csrc/selective_scan.cu``, and on any
other device an error.

Gradients.  On the CPU autograd differentiates the plain version.  On the
card, when grad is enabled and an operand requires it, the call goes
through ``_Scan`` (a ``torch.autograd.Function``): its forward launches
the forward kernel and has it write the hidden states ``h (B, S, N, Di)``
float32 as well, its backward launches the backward kernel of the same
source on them (the reference takes this gradient by XLA autodiff of its
associative scan, ``repro/models/ssm.py:82-86``).  Without grad the
forward kernel runs alone and keeps no ``h``.

Each launch adds one to ``launch_count("forward")`` or
``launch_count("backward")``; ``launch_count()`` is their sum.

Any ``S`` and ``Di`` are taken as they are: the kernel bounds-checks the
ragged ends, so nothing is padded (the reference pads S to its chunk and
Di to 128 with the neutral dA = 1, dBx = 0).
"""
from __future__ import annotations

import ctypes

import torch

from .ref import selective_scan_plain

MAX_N = 32           # N · 16 threads in a block, N ≤ 32
TD = 16              # Di columns per thread block (the kernels' kTD)
KINDS = ("forward", "backward")

_launches = dict.fromkeys(KINDS, 0)


def launch_count(kind=None) -> int:
    """Kernel launches of ``kind`` (``"forward"`` or ``"backward"``; both
    when None) since the last ``reset_launch_count()``."""
    return sum(_launches.values()) if kind is None else _launches[kind]


def reset_launch_count() -> None:
    for kind in KINDS:
        _launches[kind] = 0


def count_launches(n: int = 1, kind: str = "forward") -> None:
    """Add ``n`` to ``launch_count(kind)``: one per launch of the kernel,
    made by the wrapper or by a replay of a CUDA graph that captured it."""
    _launches[kind] += n


_LIB = None


def _lib():
    """The kernels' shared library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load("selective_scan")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_selective_scan_f32.argtypes = [P, P, P, I, L, I, I, P, P,
                                                 P]
        lib.repro_selective_scan_f32.restype = ctypes.c_int
        lib.repro_selective_scan_bwd_f32.argtypes = [P, P, P, P, I, L, I, I,
                                                     P, P, P, P]
        lib.repro_selective_scan_bwd_f32.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_limits(B, N):
    if N > MAX_N or B > 65535:
        raise ValueError(f"the CUDA selective scan takes N ≤ {MAX_N} and "
                         f"B ≤ 65535; got N={N}, B={B}")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _lib().repro_cuda_error_string(err).decode())


def _launch(dA, dBx, C, keep_h=False):
    """The forward kernel: → y, and the hidden states ``h`` when
    ``keep_h`` (else None)."""
    B, S, N, Di = dA.shape
    _check_limits(B, N)
    dA, dBx, C = (t.contiguous() for t in (dA, dBx, C))
    y = torch.empty((B, S, Di), dtype=torch.float32, device=dA.device)
    h = torch.empty_like(dA) if keep_h else None
    if y.numel() == 0:
        return y, h
    lib = _lib()
    with torch.cuda.device(dA.device):
        stream = torch.cuda.current_stream(dA.device).cuda_stream
        err = lib.repro_selective_scan_f32(
            dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), B, S, N, Di,
            y.data_ptr(), None if h is None else h.data_ptr(), stream)
    _raise_on(err, "selective_scan")
    count_launches(1, "forward")
    return y, h


def selective_scan_backward(dA, C, h, gy):
    """The backward kernel on CUDA tensors: dA, h ``(B, S, N, Di)``, C
    ``(B, S, N)`` and the output's cotangent gy ``(B, S, Di)``, all
    float32 → ``(g_dA, g_dBx, g_C)``, the plain version's
    (``ref.selective_scan_backward_plain``) function.  g_C is the sum of
    the kernel's per-slice partials ``(B, ⌈Di/16⌉, S, N)`` over the
    slices, taken on the card."""
    B, S, N, Di = dA.shape
    _check_limits(B, N)
    dA, C, h, gy = (t.contiguous() for t in (dA, C, h, gy))
    g_dA = torch.empty_like(dA)
    g_dBx = torch.empty_like(dA)
    part = torch.empty((B, -(-Di // TD), S, N), dtype=torch.float32,
                       device=dA.device)
    if g_dA.numel() == 0:
        return g_dA, g_dBx, part.sum(1)
    lib = _lib()
    with torch.cuda.device(dA.device):
        stream = torch.cuda.current_stream(dA.device).cuda_stream
        err = lib.repro_selective_scan_bwd_f32(
            dA.data_ptr(), C.data_ptr(), h.data_ptr(), gy.data_ptr(), B, S,
            N, Di, g_dA.data_ptr(), g_dBx.data_ptr(), part.data_ptr(),
            stream)
    _raise_on(err, "selective_scan backward")
    count_launches(1, "backward")
    return g_dA, g_dBx, part.sum(1)


class _Scan(torch.autograd.Function):
    """The scan on the card with its gradient: the forward kernel keeping
    ``h``, the backward kernel on it."""

    @staticmethod
    def forward(ctx, dA, dBx, C):
        y, h = _launch(dA, dBx, C, keep_h=True)
        ctx.save_for_backward(dA, C, h)
        return y

    @staticmethod
    def backward(ctx, gy):
        dA, C, h = ctx.saved_tensors
        return selective_scan_backward(dA, C, h, gy)


def selective_scan(dA, dBx, C):
    """dA/dBx ``(B, S, N, Di)``, C ``(B, S, N)`` → y ``(B, S, Di)``
    float32.  The plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (with its backward kernel when a gradient is wanted)."""
    if dA.ndim != 4 or dBx.shape != dA.shape or C.ndim != 3 \
            or tuple(C.shape) != tuple(dA.shape[:3]):
        raise ValueError("selective_scan takes dA and dBx (B, S, N, Di) and "
                         f"C (B, S, N); got {tuple(dA.shape)}, "
                         f"{tuple(dBx.shape)} and {tuple(C.shape)}")
    if len({dA.device, dBx.device, C.device}) != 1:
        raise ValueError("operands on several devices: "
                         f"{dA.device}, {dBx.device}, {C.device}")
    dA, dBx, C = (t.to(torch.float32) for t in (dA, dBx, C))
    if dA.device.type == "cpu":
        return selective_scan_plain(dA, dBx, C)
    if dA.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, not "
                         f"{dA.device}")
    if torch.is_grad_enabled() and (dA.requires_grad or dBx.requires_grad
                                    or C.requires_grad):
        return _Scan.apply(dA, dBx, C)
    return _launch(dA, dBx, C)[0]
