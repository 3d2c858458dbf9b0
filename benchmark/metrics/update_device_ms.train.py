"""Device-clock ms of a train step's `trainer.update` span (norm, clip, Adam,
idle inside it included), median over the profiled steps."""

from benchmark.program_trace import span_ms


def read(ctx):
    return span_ms("trainer.step", "trainer.update", "device_ms")
