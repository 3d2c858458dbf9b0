"""Host ms of a train step's `trainer.backward` span, median over the profiled steps."""

from benchmark.program_trace import span_ms


def read(ctx):
    return span_ms("trainer.step", "trainer.backward", "host_ms")
