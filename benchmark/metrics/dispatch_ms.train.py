"""Host ms to enqueue one train call from an idle device, median of three, no sync inside."""

from benchmark.metrics import dispatch_ms


def read(ctx):
    return dispatch_ms(ctx, "train")
