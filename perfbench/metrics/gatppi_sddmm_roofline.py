"""The SDDMM kernels' share of their roofline in the additive GAT's step,
in %: ``sddmm_roofline``'s reading, with the driver's work count from
``work_gat.py`` (the fused SDDMM → softmax stats on the 2-wide operands
[el, 1] and [1, er], and the raw SDDMM dα at each layer's F′)."""
from perfbench.metrics.sddmm_roofline import read  # noqa: F401
