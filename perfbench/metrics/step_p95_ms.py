"""95th percentile (nearest rank) of the traced run's window step times
before CUPTI started.  A per-layer metric:
the tail moves with the host's state far more than the mean does (a
set's spread reached 20% on one card), too much for a bound."""
from perfbench import bench


def read(ctx):
    if len(ctx.steps_s) < 20:
        return None
    return bench.nearest_rank(ctx.steps_s, 0.95) * 1e3
