"""Blocking host-device synchronisations a forward: the program's `syncs` counter under `tsvad.forward`."""

from benchmark.program_trace import counter


def read(ctx):
    return counter("tsvad.forward", "syncs")
