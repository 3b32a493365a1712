"""The SDDMM kernels' share of their roofline, in %: the least time of a
step's SDDMMs (the fused SDDMM → softmax stats and the raw SDDMM,
``work.py``) over the profiler's device time a step of the
``sddmm_softmax*`` and ``sddmm_kernel`` families."""
from perfbench import work

FAMILIES = {"sddmm_softmax", "sddmm"}


def read(ctx):
    if ctx.prof is None:
        return None
    by = ctx.prof.seconds_by(work.kernel_family)
    dev = sum(by.get(f, 0.0) for f in FAMILIES)
    least = work.least_s(ctx.ops, FAMILIES)
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / (dev / ctx.prof.steps)
