"""Phase 1 of the ParamSpMM workflow (paper Fig. 2): configuration
prediction.  PCSR generation is ``core.pcsr.build_pcsr``; the computing
engine is ``kernels.paramspmm.ops.paramspmm``."""
from __future__ import annotations

from .core import CostModel, CSRMatrix, H100, Hardware, SpMMConfig, config_space


def pick_config(csr: CSRMatrix, dim: int, *, decider=None,
                select: str = "model", op: str = "spmm", heads: int = 1,
                hardware: Hardware = H100) -> SpMMConfig:
    """Configuration pick shared by every entry point: a cost-model sweep
    over ``config_space`` priced for ``hardware``.  The serving tier
    calls it once per shape bucket.

    The trained decider and the measured oracle search are not ported
    yet (ROADMAP Queue 1 item 7).
    """
    if decider is not None:
        raise NotImplementedError(
            "decider-driven config pick is not ported yet "
            "(ROADMAP Queue 1 item 7)")
    if select == "measured":
        raise NotImplementedError(
            "measured oracle search is not ported yet "
            "(ROADMAP Queue 1 item 7)")
    config, _ = CostModel(csr, hardware).best(dim, config_space(dim),
                                              op=op, H=heads)
    return config
