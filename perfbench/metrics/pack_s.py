"""Seconds of the program's pack and config pick: its ``gnn.pack`` span
(reorder, cost-model pick, PCSR of A and Aᵀ, steering to the device)."""


def read(ctx):
    durs = [e["dur"] for e in ctx.spans
            if e.get("ph") == "X" and e.get("name") == "gnn.pack"]
    return sum(durs) * 1e-6 if durs else None
