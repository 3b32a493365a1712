"""The additive GAT's whole step as a share of the float32 peak, in %:
``step_mfu``'s reading, with the model FLOPs of ``work_gat.py``."""
from perfbench.metrics.step_mfu import read  # noqa: F401
