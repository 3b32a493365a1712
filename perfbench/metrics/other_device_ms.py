"""Device ms a step outside the three kernel families: the dense layers,
the loss, autograd's elementwise work, AdamW, copies and fills."""
from perfbench import work


def read(ctx):
    if ctx.prof is None or not ctx.prof.ops:
        return None
    other = ctx.prof.seconds_by(work.kernel_family).get("other", 0.0)
    return other / ctx.prof.steps * 1e3
