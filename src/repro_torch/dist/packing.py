"""Each rank's own pack of its shard.

The JAX package pads every shard's steering to one shape and stacks them
into mesh tensors (one SPMD program reads them all).  Here a rank packs
and stages on its device only its own shard, at that shard's own shapes
and config — no cross-shard padding:

* ``op`` — the shard matrix ``A_p`` ``(rows_pad, rows_pad + halo_pad)``
  and its transpose as a ``core.engine.ParamSpMMOperator`` (PCSR of both,
  the differentiable SpMM and fused SpMM, the steering on the device);
* under overlap, ``loc`` and ``halo`` — the same for the local
  ``(rows_pad, rows_pad)`` and halo ``(rows_pad, halo_pad)`` parts of
  ``A_p`` (``partition.split_local_halo``), each under its own config.
  The SpMM paths then read only these two, so ``op`` is packed at its
  first use (the GAT message, which always runs on the whole shard).

The GAT message runs over ``op``'s PCSR pair; the slot map between the
two (``core.engine.TransposeSide``) is staged at its first backward.
Each rank builds its packs in its own process, so their device state
(``Steering``, ``SteeringArgs``) is never shared between ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.engine import ParamSpMMOperator
from repro_torch.core.pcsr import SpMMConfig
from repro_torch.core.sparse import CSRMatrix


@dataclass
class ShardPack:
    """One rank's packed operators (``loc``/``halo`` under overlap)."""

    csr: CSRMatrix
    config: SpMMConfig
    device: object
    loc: Optional[ParamSpMMOperator] = None
    halo: Optional[ParamSpMMOperator] = None
    _op: Optional[ParamSpMMOperator] = None

    @property
    def op(self) -> ParamSpMMOperator:
        """The whole shard matrix and its transpose, packed on first use."""
        if self._op is None:
            self._op = ParamSpMMOperator(self.csr, self.config,
                                         build_transpose=True,
                                         device=self.device)
        return self._op


def pack_shard(csr: CSRMatrix, config: SpMMConfig, device, *,
               split=None, split_configs=None) -> ShardPack:
    """Pack ``csr`` under ``config`` on ``device``; with ``split`` (the
    ``(local, halo)`` CSRs) and ``split_configs`` both parts instead, the
    whole matrix then at its first use."""
    pack = ShardPack(csr, config, device)
    if split is None:
        pack.op                                  # packed and staged now
        return pack
    (loc, hal), (lc, hc) = split, split_configs
    pack.loc = ParamSpMMOperator(loc, lc, build_transpose=True,
                                 device=device)
    pack.halo = ParamSpMMOperator(hal, hc, build_transpose=True,
                                  device=device)
    return pack
