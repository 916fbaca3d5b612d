"""Milliseconds of the pipeline's "decode" phase (the VAE decode and the
images to uint8; PhaseTimer, synchronised), a call."""
from portbench.layers import phase_ms


def read(run):
    return phase_ms(run, "decode")
