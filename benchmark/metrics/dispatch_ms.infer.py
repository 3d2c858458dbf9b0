"""Host ms to enqueue one infer call from an idle device, median of three, no sync inside."""

from benchmark.metrics import dispatch_ms


def read(ctx):
    return dispatch_ms(ctx, "infer")
