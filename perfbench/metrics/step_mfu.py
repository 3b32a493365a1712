"""The whole step's share of the float32 peak, in %: the model FLOPs of a
step (dense matmuls, aggregations and SDDMMs, ``work.py``) over the mean
time of the traced window's steps before CUPTI started × 67 TFLOP/s (float32
outside the tensor cores: the configurations run float32 with TF32
off)."""
from perfbench import work


def read(ctx):
    if ctx.device.type != "cuda" or ctx.step_s <= 0:
        return None
    return 100.0 * work.model_flops(ctx.ops) / (ctx.step_s
                                                * work.F32_FLOP_PER_S)
