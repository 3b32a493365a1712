"""Seconds of the pack's config pick: the program's ``pack.pick`` spans
inside ``gnn.pack`` (``pick_config``, the cost model's sweep here)."""
from perfbench import spans


def read(ctx):
    return spans.held_s(ctx.spans, "pack.pick", "gnn.pack")
