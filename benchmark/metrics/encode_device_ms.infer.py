"""Device-clock ms of a forward's `tsvad.encode` span (fbank, CAM++, speech_down), median over the profiled forwards."""

from benchmark.program_trace import span_ms


def read(ctx):
    return span_ms("tsvad.forward", "tsvad.encode", "device_ms")
