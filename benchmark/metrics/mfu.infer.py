"""Model FLOPs of the window's infer calls a second, in percent of the bf16 peak (costs/flops.py)."""

from benchmark.metrics import mfu


def read(ctx):
    return mfu(ctx, "infer")
