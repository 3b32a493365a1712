"""The selective scan on tensors: the CUDA kernel's wrapper.

``selective_scan(dA, dBx, C)`` takes the JAX package's signature and
shapes (``repro/kernels/selective_scan/ops.py``): dA/dBx ``(B, S, N,
Di)``, C ``(B, S, N)`` → y ``(B, S, Di)`` float32, every operand cast to
float32 first.  It picks the implementation by the device of ``dA``: on a
CPU tensor the plain version (``ref.selective_scan_plain``), on a CUDA
tensor the kernel in ``repro_torch/csrc/selective_scan.cu``, and on any
other device an error.  Each kernel launch adds one to ``launch_count()``.

Any ``S`` and ``Di`` are taken as they are: the kernel bounds-checks the
ragged ends, so nothing is padded (the reference pads S to its chunk and
Di to 128 with the neutral dA = 1, dBx = 0).
"""
from __future__ import annotations

import ctypes

import torch

from .ref import selective_scan_plain

MAX_N = 32           # N · 16 threads in a block, N ≤ 32

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count()``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def count_launches(n: int = 1) -> None:
    """Add ``n`` to ``launch_count()``: one per launch of the kernel, made
    by the wrapper or by a replay of a CUDA graph that captured it."""
    global _launches
    _launches += n


_LIB = None


def _lib():
    """The kernel's shared library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load("selective_scan")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_selective_scan_f32.argtypes = [P, P, P, I, L, I, I, P, P]
        lib.repro_selective_scan_f32.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(dA, dBx, C):
    B, S, N, Di = dA.shape
    if N > MAX_N or B > 65535:
        raise ValueError(f"the CUDA selective scan takes N ≤ {MAX_N} and "
                         f"B ≤ 65535; got N={N}, B={B}")
    dA, dBx, C = (t.contiguous() for t in (dA, dBx, C))
    y = torch.empty((B, S, Di), dtype=torch.float32, device=dA.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(dA.device):
        stream = torch.cuda.current_stream(dA.device).cuda_stream
        err = lib.repro_selective_scan_f32(
            dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), B, S, N, Di,
            y.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("selective_scan kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    count_launches()
    return y


def selective_scan(dA, dBx, C):
    """dA/dBx ``(B, S, N, Di)``, C ``(B, S, N)`` → y ``(B, S, Di)``
    float32.  The plain version for CPU tensors, the CUDA kernel for CUDA
    tensors."""
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
    return _launch(dA, dBx, C)
