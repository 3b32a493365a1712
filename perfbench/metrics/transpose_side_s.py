"""Seconds of GAT's transpose side: the program's ``gat.transpose_side``
spans (the slot transfer map, Aᵀ's steering and the two index tensors on
the device), built in step 0's backward."""
from perfbench import spans


def read(ctx):
    durs = [e["dur"] for e in spans.complete(ctx.spans, "gat.transpose_side")]
    return sum(durs) * 1e-6 if durs else None
