"""Seconds from the process's start to the window's: importing, the kernel
build where it is not cached, drawing the weights on the card, building the
pipeline and warming every shape of the cell."""


def read(run):
    return run.setup_s
