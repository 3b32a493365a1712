"""Seconds of the PCSR builds: the program's ``pack.pcsr`` spans inside
``gnn.pack`` (A's PCSR, the CSR transpose and Aᵀ's PCSR)."""
from perfbench import spans


def read(ctx):
    return spans.held_s(ctx.spans, "pack.pcsr", "gnn.pack")
