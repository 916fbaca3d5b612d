"""Milliseconds of the pipeline's "text" phase (the group's text encode
through both towers; PhaseTimer, synchronised), a call. A program without
that phase gives nothing to read."""
from portbench.layers import phase_ms


def read(run):
    return phase_ms(run, "text")
