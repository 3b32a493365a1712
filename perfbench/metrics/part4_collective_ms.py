"""Device ms a profiled step that rank 0's card spends in NCCL's kernels
(by name): the halo exchange's all-gather and send/recv and the
gradient all-reduce's all-gather.  A kernel runs from its launch until
its peers' data has come, so the waits on slower ranks count too."""


def read(ctx):
    if ctx.prof is None or not ctx.prof.ops:
        return None
    s = sum(d for name, _, d in ctx.prof.ops if "nccl" in name.lower())
    return s / ctx.prof.steps * 1e3 if s > 0 else None
