"""The ParamSpMM kernel's share of its roofline in the additive GAT's step,
in %: ``spmm_roofline``'s reading, with the driver's work count from
``work_gat.py`` (the prologue SpMM and dVf at each layer's F′, dQ and dK
at the 2-wide attention operands)."""
from perfbench.metrics.spmm_roofline import read  # noqa: F401
