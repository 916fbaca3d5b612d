"""Milliseconds of the pipeline's "encode" phase (the per-request PwW
pyramids, time ids and noise, and the text encode where the program has no
"text" phase; PhaseTimer, synchronised), a call."""
from portbench.layers import phase_ms


def read(run):
    return phase_ms(run, "encode")
