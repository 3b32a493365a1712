"""Host ms to issue a step: the median, over the traced run's window steps
before CUPTI started (steps 1 … ``len(ctx.steps_s)``), of each
``gnn.step`` span less its ``gnn.sync`` child (the loss to the host and
the synchronise).  Waits inside the other phases are included."""
import statistics

from perfbench import spans


def read(ctx):
    n = len(ctx.steps_s)
    by_step = lambda name: {e["args"].get("step"): e["dur"]
                            for e in spans.complete(ctx.spans, name)}
    steps, syncs = by_step("gnn.step"), by_step("gnn.sync")
    host = [steps[k] - syncs[k] for k in range(1, n + 1)
            if k in steps and k in syncs]
    return statistics.median(host) * 1e-3 if host else None
