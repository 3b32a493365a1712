"""Device-idle ms a step while the host was in the program's
``gnn.forward`` range, over the labelled window (profiled with the host,
so it reads high against ``device_idle``): ``spans.idle_in_ms``."""
from perfbench import spans


def read(ctx):
    return spans.idle_in_ms(ctx.labels, "gnn.forward")
