"""Device ms a train call: the profiled stretch's kernel, copy and set time over its calls."""

from benchmark.metrics import device_ms


def read(ctx):
    return device_ms(ctx, "train")
