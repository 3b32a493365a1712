"""The selective scan on tensors: the CUDA kernels' wrappers.

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
the forward kernel and has it write the hidden state at the end of every
``CHUNK``-step chunk, ``states (B, ⌈S/CHUNK⌉, N, Di)`` float32, and saves
``(dA, dBx, C, states)``; its backward launches the backward kernel of
the same source, which rebuilds each chunk's hidden states from them (the
reference takes this gradient by XLA autodiff of its associative scan,
``repro/models/ssm.py:82-86``).  Without grad the forward kernel runs
alone and keeps no states.

Each launch adds one to ``launch_count("forward")`` or
``launch_count("backward")``; ``launch_count()`` is their sum.  The
backward's one launch carries its chunks' cotangent from the last chunk
to the first itself (a chained scan over blocks), so it has no helper
launch; its per-slice partial sums of g_C are summed by one ``torch.sum``.

On the mesh path (DTensor operands) and while the dry run counts
(``models.common.cost_mode()``), the call goes through the custom ops
``repro_torch::selective_scan_fwd`` / ``selective_scan_bwd``: the same
kernels on CUDA tensors (the plain versions on the CPU), with a fake
implementation that gives their shapes, an autograd formula (the
backward op on the forward's chunk states) and a DTensor sharding rule:
B over any mesh dimension, or Di (C replicated), or nothing.  Each rank
then launches the kernel on its own ``(B/dp, S, N, Di/mp)`` block, and
the launch counts are per process (per rank).

Any ``S`` and ``Di`` are taken as they are: the kernels bounds-check the
ragged ends, so nothing is padded (the reference pads S to its chunk and
Di to 128 with the neutral dA = 1, dBx = 0).
"""
from __future__ import annotations

import ctypes

import torch

from .ref import (selective_scan_backward_from_states_plain,
                  selective_scan_chunk_states_plain, selective_scan_plain)

MAX_N = 32           # N · 16 threads in a forward block, N ≤ 32
CHUNK = 64           # steps per chunk state (the kernels' kChunk)
BWD_TD = 32          # backward: Di columns per block (kBwdTD)
BWD_TN = 4           # backward: states n per block (kBwdTN)
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
    """The kernels' shared library, built and bound on first use; its
    chunk length and backward tile are checked against ``CHUNK``,
    ``BWD_TD`` and ``BWD_TN``."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load("selective_scan")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_selective_scan_f32.argtypes = [P, P, P, I, L, I, I, P, P,
                                                 P]
        lib.repro_selective_scan_f32.restype = ctypes.c_int
        lib.repro_selective_scan_bwd_f32.argtypes = [P, P, P, P, P, I, L, I,
                                                     I, P, P, P, P, P, P]
        lib.repro_selective_scan_bwd_f32.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        got = [ctypes.c_int() for _ in range(3)]
        lib.repro_selective_scan_layout(*(ctypes.byref(v) for v in got))
        if tuple(v.value for v in got) != (CHUNK, BWD_TD, BWD_TN):
            raise RuntimeError("selective_scan.cu's layout (chunk, Di "
                               "columns, states n) is "
                               f"{tuple(v.value for v in got)}, the wrapper "
                               f"takes {(CHUNK, BWD_TD, BWD_TN)}")
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


def _chunks(S: int) -> int:
    return -(-S // CHUNK)


def _launch(dA, dBx, C, states=False):
    """The forward kernel: → y, and the chunk states ``(B, ⌈S/CHUNK⌉, N,
    Di)`` when ``states`` (else None)."""
    B, S, N, Di = dA.shape
    _check_limits(B, N)
    dA, dBx, C = (t.contiguous() for t in (dA, dBx, C))
    y = torch.empty((B, S, Di), dtype=torch.float32, device=dA.device)
    st = (torch.empty((B, _chunks(S), N, Di), dtype=torch.float32,
                      device=dA.device) if states else None)
    if y.numel() == 0:
        return y, st
    lib = _lib()
    with torch.cuda.device(dA.device):
        stream = torch.cuda.current_stream(dA.device).cuda_stream
        err = lib.repro_selective_scan_f32(
            dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), B, S, N, Di,
            y.data_ptr(), None if st is None else st.data_ptr(), stream)
    _raise_on(err, "selective_scan")
    count_launches(1, "forward")
    return y, st


def selective_scan_backward(dA, dBx, C, states, gy):
    """The scan's gradient: dA, dBx ``(B, S, N, Di)``, C ``(B, S, N)``,
    the forward's chunk states ``(B, ⌈S/CHUNK⌉, N, Di)`` and the output's
    cotangent gy ``(B, S, Di)``, all float32 → ``(g_dA, g_dBx, g_C)``, the
    plain version's (``ref.selective_scan_backward_plain``) function::

        gh_t     = gy_t · C_t + dA_{t+1} ⊙ gh_{t+1}      (gh_S = 0)
        g_dBx_t  = gh_t
        g_dA_t   = gh_t ⊙ h_{t−1}                        (h_{−1} = 0)
        g_C_t[n] = Σ_d gy_t[d] · h_t[n, d]

    with each h_t rebuilt from the chunk state before it.  On CUDA
    tensors the backward kernel (one launch; g_C is the sum of its
    per-slice partials ``(B, ⌈Di/BWD_TD⌉, S, N)`` over the slices, taken
    on the card); on CPU tensors the plain version
    (``ref.selective_scan_backward_from_states_plain``)."""
    B, S, N, Di = dA.shape
    if dA.device.type == "cpu":
        return selective_scan_backward_from_states_plain(dA, dBx, C, states,
                                                         gy, CHUNK)
    if dA.device.type != "cuda":
        raise ValueError(f"selective_scan_backward runs on cpu or cuda, "
                         f"not {dA.device}")
    if N > MAX_N:
        raise ValueError(f"the CUDA selective scan backward takes N ≤ "
                         f"{MAX_N}; got N={N}")
    dA, dBx, C, states, gy = (t.contiguous() for t in (dA, dBx, C, states,
                                                       gy))
    g_dA = torch.empty_like(dA)
    g_dBx = torch.empty_like(dA)
    nslices, ngroups = -(-Di // BWD_TD), -(-N // BWD_TN)
    part = torch.empty((B, nslices, S, N), dtype=torch.float32,
                       device=dA.device)
    if g_dA.numel() == 0:
        return g_dA, g_dBx, part.sum(1)
    if B * _chunks(S) * nslices * ngroups >= 2 ** 31:
        raise ValueError("the CUDA selective scan backward takes fewer than "
                         f"2^31 blocks; got (B, S, N, Di) = {(B, S, N, Di)}")
    # each chunk's cotangent carry, unset (all bits 1) until its block
    # writes it; and the block ticket counter
    carry = torch.empty_like(states)
    carry.view(torch.int32).fill_(-1)
    sync = torch.zeros(1, dtype=torch.int32, device=dA.device)
    lib = _lib()
    with torch.cuda.device(dA.device):
        stream = torch.cuda.current_stream(dA.device).cuda_stream
        err = lib.repro_selective_scan_bwd_f32(
            dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), states.data_ptr(),
            gy.data_ptr(), B, S, N, Di, g_dA.data_ptr(), g_dBx.data_ptr(),
            part.data_ptr(), carry.data_ptr(), sync.data_ptr(), stream)
    _raise_on(err, "selective_scan backward")
    count_launches(1, "backward")
    return g_dA, g_dBx, part.sum(1)


class _Scan(torch.autograd.Function):
    """The scan on the card with its gradient: the forward kernel keeping
    the chunk states, the backward kernel on them."""

    @staticmethod
    def forward(ctx, dA, dBx, C):
        y, states = _launch(dA, dBx, C, states=True)
        ctx.save_for_backward(dA, dBx, C, states)
        return y

    @staticmethod
    def backward(ctx, gy):
        return selective_scan_backward(*ctx.saved_tensors, gy)


# ------------------------------------------------------------ custom ops
@torch.library.custom_op("repro_torch::selective_scan_fwd", mutates_args=())
def _fwd_op(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
            keep_states: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """y and, with ``keep_states``, the chunk states (else a (B, 0, N,
    Di) tensor): the kernel on CUDA, the plain versions on the CPU."""
    B, S, N, Di = dA.shape
    y, st = _forward(dA, dBx, C, keep_states)
    return y, (dA.new_empty((B, 0, N, Di)) if st is None else st)


def _forward(dA, dBx, C, keep_states):
    if dA.device.type == "cuda":
        return _launch(dA, dBx, C, states=keep_states)
    return (selective_scan_plain(dA, dBx, C),
            selective_scan_chunk_states_plain(dA, dBx, CHUNK)
            if keep_states else None)


@_fwd_op.register_fake
def _(dA, dBx, C, keep_states):
    B, S, N, Di = dA.shape
    return (dA.new_empty((B, S, Di)),
            dA.new_empty((B, _chunks(S) if keep_states else 0, N, Di)))


@torch.library.custom_op("repro_torch::selective_scan_bwd", mutates_args=())
def _bwd_op(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
            states: torch.Tensor, gy: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return selective_scan_backward(dA, dBx, C, states, gy)


@_bwd_op.register_fake
def _(dA, dBx, C, states, gy):
    return torch.empty_like(dA), torch.empty_like(dA), torch.empty_like(C)


def _setup(ctx, inputs, output):
    dA, dBx, C, _ = inputs
    ctx.save_for_backward(dA, dBx, C, output[1])


def _backward(ctx, gy, _gst):
    g_dA, g_dBx, g_C = torch.ops.repro_torch.selective_scan_bwd(
        *ctx.saved_tensors, gy.contiguous())
    return g_dA, g_dBx, g_C, None


_fwd_op.register_autograd(_backward, setup_context=_setup)


def _register_sharding():
    """B over a mesh dimension, or Di with C whole, or replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    R = Replicate()

    @register_sharding(torch.ops.repro_torch.selective_scan_fwd.default)
    def _fwd(dA, dBx, C, keep_states):
        return [([R, R], [R, R, R, None]),
                ([Shard(0), Shard(0)], [Shard(0), Shard(0), Shard(0), None]),
                ([Shard(2), Shard(3)], [Shard(3), Shard(3), R, None])]

    @register_sharding(torch.ops.repro_torch.selective_scan_bwd.default)
    def _bwd(dA, dBx, C, states, gy):
        return [([R, R, R], [R, R, R, R, R]),
                ([Shard(0)] * 3, [Shard(0)] * 5),
                # g_C sums over Di: a partial sum on each Di shard
                ([Shard(3), Shard(3), _partial()],
                 [Shard(3), Shard(3), R, Shard(3), Shard(2)])]


def _partial():
    from torch.distributed.tensor import Partial
    return Partial()


_register_sharding()


def _scan_op(dA, dBx, C):
    keep = torch.is_grad_enabled() and (dA.requires_grad or dBx.requires_grad
                                        or C.requires_grad)
    return torch.ops.repro_torch.selective_scan_fwd(dA, dBx, C, keep)[0]


def selective_scan(dA, dBx, C):
    """dA/dBx ``(B, S, N, Di)``, C ``(B, S, N)`` → y ``(B, S, Di)``
    float32.  The plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (with its backward kernel when a gradient is wanted); DTensor
    operands, and any operands in cost mode, through the custom ops."""
    if dA.ndim != 4 or dBx.shape != dA.shape or C.ndim != 3 \
            or tuple(C.shape) != tuple(dA.shape[:3]):
        raise ValueError("selective_scan takes dA and dBx (B, S, N, Di) and "
                         f"C (B, S, N); got {tuple(dA.shape)}, "
                         f"{tuple(dBx.shape)} and {tuple(C.shape)}")
    if len({dA.device, dBx.device, C.device}) != 1:
        raise ValueError("operands on several devices: "
                         f"{dA.device}, {dBx.device}, {C.device}")
    dA, dBx, C = (t.to(torch.float32) for t in (dA, dBx, C))
    from torch.distributed.tensor import DTensor
    from repro_torch.models.common import cost_mode
    if cost_mode() or any(isinstance(t, DTensor) for t in (dA, dBx, C)):
        return _scan_op(dA, dBx, C)
    if dA.device.type == "cpu":
        return selective_scan_plain(dA, dBx, C)
    if dA.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, not "
                         f"{dA.device}")
    if torch.is_grad_enabled() and (dA.requires_grad or dBx.requires_grad
                                    or C.requires_grad):
        return _Scan.apply(dA, dBx, C)
    return _launch(dA, dBx, C)[0]
