"""The ParamSpMM kernel's share of its roofline on rank 0's card of the
partitioned GCN, in %: ``spmm_roofline``'s reading, with the work of
rank 0's shard (``drivers/train_gnn_part.py::_trace_context``)."""
from perfbench.metrics.spmm_roofline import read  # noqa: F401
