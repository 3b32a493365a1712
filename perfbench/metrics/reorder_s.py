"""Seconds of the pack's locality reorder: the program's ``pack.reorder``
spans inside ``gnn.pack`` (``rabbit_reorder``, the relabelling and the two
V=2 padding-ratio passes)."""
from perfbench import spans


def read(ctx):
    return spans.held_s(ctx.spans, "pack.reorder", "gnn.pack")
