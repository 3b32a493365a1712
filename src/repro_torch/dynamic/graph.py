"""``DynamicGraph``: the operator surface of a mutating graph.

Owns a :class:`~repro_torch.dynamic.pcsr.DynamicPCSR`, a
:class:`~repro_torch.dynamic.governor.RepackGovernor`, and the operators
built over the current layout view.  Every mutation batch runs the
governor; with ``auto_heal=True`` (the default) its verdict is acted on
at once — ``reselect`` swaps the F tile on the live arrays, ``repack``
rebuilds the pack under a fresh config pick — so a caller streaming edges
never schedules maintenance, and every ``spmm`` / ``gat`` stays exact
(the view always encodes the live edge set; only its speed was at stake).

On a CUDA device the operators are the hand-written kernels over the
live view's ``Steering`` (``kernels.paramspmm.ops.device_steering``,
staged when the operators of a version are built): the ParamSpMM kernel
for ``spmm``, the fused SDDMM → softmax stats and the ParamSpMM softmax
prologue for ``gat``.  On the CPU their plain versions run.  Operands on
another device are moved to the graph's; nothing falls back.

The operators are dropped when, and only when, ``dyn.version`` moves,
and rebuilt at the next call: a new view, its ``Steering`` and the copy
to the device.  Gradients come from Aᵀ's pack of that version's view,
built at its first backward and shared by ``spmm`` (one ParamSpMM
launch) and ``gat`` (the raw SDDMM for dα and three ParamSpMMs).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.cost_model import (H100, PACK_SETUP_H100, CostModel,
                                         Hardware, PackSetup)
from repro_torch.core.engine import make_gat_message_fn, make_spmm_fn
from repro_torch.core.pcsr import SpMMConfig, config_space, transpose_pcsr
from repro_torch.core.sparse import CSRMatrix
from repro_torch.device import check_backend, resolve_device
from repro_torch.obs import trace as _obs_trace

from .governor import GovernorDecision, RepackGovernor
from .pcsr import DynamicPCSR, MutationReport


class DynamicGraph:
    """A mutable graph with always-exact, self-healing SpMM and GAT.

    ``device`` (default CUDA; raises without a card) is where the
    operators run.  ``backend`` and ``interpret`` are the JAX package's
    keywords: the device picks kernels or plain versions, ``"engine"``
    (the plain traversal) is the CPU path and raises on a CUDA device.
    ``auto_heal=False`` keeps the governor advisory-only (its decisions
    still append to ``self.decisions``), so a caller can re-pack at its
    own cadence with ``repack()``.  ``hardware`` prices the config picks
    and the governor's verdicts (``calibration``, a
    ``core.calibrate.CalibrationResult`` or artifact path, instead when
    given); ``pack_setup`` prices a re-pack.
    """

    def __init__(self, csr: CSRMatrix, dim: int, *,
                 config: Optional[SpMMConfig] = None,
                 backend: Optional[str] = None, interpret: bool = True,
                 heads: int = 1, space=None, calibration=None,
                 slack: float = 1.25, amortize_steps: int = 100,
                 drift_threshold=None, auto_heal: bool = True,
                 hardware: Hardware = H100,
                 pack_setup: PackSetup = PACK_SETUP_H100, device=None):
        device = resolve_device(device)
        check_backend(backend, device)
        if calibration is not None and not hasattr(calibration, "price"):
            from repro_torch.core.calibrate import CalibrationResult
            calibration = CalibrationResult.load(calibration)
        self.dim = dim
        self.backend = backend
        self.interpret = interpret
        self.heads = heads
        self.device = device
        self.space = space or config_space(dim)
        self.calibration = calibration
        self.hardware = hardware
        if config is None:
            config = self._pick(csr)
        self.dyn = DynamicPCSR.from_csr(csr, config)
        self.governor = RepackGovernor(
            dim, heads=heads, space=self.space, calibration=calibration,
            slack=slack, amortize_steps=amortize_steps,
            drift_threshold=drift_threshold, hardware=hardware,
            pack_setup=pack_setup)
        self.governor.rebaseline(self.dyn, config)
        self.auto_heal = auto_heal
        self.decisions: list[GovernorDecision] = []
        self._fn_version = -1
        self._spmm_fn = None
        self._gat_fns: dict = {}
        self._transpose = None

    def _pick(self, csr: CSRMatrix) -> SpMMConfig:
        return CostModel(csr, self.hardware,
                         calibration=self.calibration).best(
            self.dim, self.space, H=self.heads)[0]

    @property
    def config(self) -> SpMMConfig:
        return self.dyn.config

    @property
    def version(self) -> int:
        return self.dyn.version

    # -------------------------------------------------------- mutation
    def insert_edges(self, rows, cols, values
                     ) -> tuple[MutationReport, GovernorDecision]:
        rep = self.dyn.insert_edges(rows, cols, values)
        return rep, self._govern()

    def delete_edges(self, rows, cols
                     ) -> tuple[MutationReport, GovernorDecision]:
        rep = self.dyn.delete_edges(rows, cols)
        return rep, self._govern()

    def _govern(self) -> GovernorDecision:
        dec = self.governor.evaluate(self.dyn, self.config)
        if self.auto_heal:
            if dec.action == "repack":
                self.repack(dec.config)
            elif dec.action == "reselect":
                self.dyn.reselect(dec.config)
        self.decisions.append(dec)
        return dec

    def repack(self, config: Optional[SpMMConfig] = None) -> SpMMConfig:
        """Full re-pack of the live edge set; ``config=None`` re-runs the
        config pick on the mutated graph."""
        if config is None:
            config = self._pick(self.dyn.to_csr())
        with _obs_trace.span("dynamic.repack",
                             config=str(config.astuple()),
                             nnz=int(self.dyn.nnz)):
            self.dyn.repack(config)
        self.governor.rebaseline(self.dyn, config)
        return config

    # -------------------------------------------------------- operators
    def _refresh(self) -> None:
        """Drop the operators when the version moved; build the view, its
        steering on the device and the lazy transpose when missing."""
        if self._fn_version != self.dyn.version:
            self._spmm_fn = None
            self._gat_fns = {}
            self._transpose = None
            self._fn_version = self.dyn.version
        if self._transpose is None:
            from repro_torch.kernels.paramspmm.ops import device_steering
            view = self.dyn.pcsr
            device_steering(view, self.device)
            self._transpose = functools.cache(lambda: transpose_pcsr(view))

    def _operand(self, x):
        return torch.as_tensor(x).to(self.device)

    def spmm(self, B):
        """``C = A·B`` over the live (possibly degraded) layout — exact;
        differentiable in ``B``."""
        self._refresh()
        if self._spmm_fn is None:
            self._spmm_fn = make_spmm_fn(self.dyn.pcsr, self._transpose)
        return self._spmm_fn(self._operand(B))

    def gat(self, Q, K_mat, Vf, *, slope: float = 0.2):
        """Fused GAT message over the live layout — exact (tombstoned
        cells are masked, delta-chunk padding carries −inf logits);
        ``(H, n, d)`` operands run every head in the same launches.
        Differentiable in ``Q``, ``K_mat`` and ``Vf``."""
        self._refresh()
        if slope not in self._gat_fns:
            self._gat_fns[slope] = make_gat_message_fn(
                self.dyn.pcsr, self._transpose, slope=slope)
        return self._gat_fns[slope](self._operand(Q), self._operand(K_mat),
                                    self._operand(Vf))
