"""Device-clock ms of a forward's `tsvad.backends` span (the single and multi
backends, backend_down, fc), median over the profiled forwards."""

from benchmark.program_trace import span_ms


def read(ctx):
    return span_ms("tsvad.forward", "tsvad.backends", "device_ms")
