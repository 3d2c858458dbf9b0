"""Blocking host-device synchronisations a train step: the program's `syncs` counter under `trainer.step`."""

from benchmark.program_trace import counter


def read(ctx):
    return counter("trainer.step", "syncs")
