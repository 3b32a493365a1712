"""Share of a step, in %, in which no device op ran: the profiled steps'
device busy time a step (``devtrace.DeviceWindow``) over the mean time of
the window's steps before CUPTI started.  CUPTI lengthens every step
after it starts, so the profiled steps' own idle time is not read."""


def read(ctx):
    if ctx.prof is None or ctx.prof.busy_s <= 0 or ctx.step_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.prof.busy_s / ctx.prof.steps / ctx.step_s)
