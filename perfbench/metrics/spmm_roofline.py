"""The ParamSpMM kernel's share of its roofline, in %: the least time of
a step's aggregations (``work.py``) over the profiler's device time a step
of the ``paramspmm_kernel`` + ``paramspmm_merge_kernel`` family."""
from perfbench import work


def read(ctx):
    if ctx.prof is None:
        return None
    dev = ctx.prof.seconds_by(work.kernel_family).get("paramspmm", 0.0)
    least = work.least_s(ctx.ops, {"paramspmm"})
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / (dev / ctx.prof.steps)
