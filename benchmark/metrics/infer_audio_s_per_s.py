"""Audio seconds of the infer traffic's windows a second of the window (host clock)."""

from benchmark.metrics import rate


def read(ctx):
    return rate(ctx, "infer")
