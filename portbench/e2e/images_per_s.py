"""Images a second: the images of every request sent in the window, over
the span until the last of them resolved (``windows``)."""
from portbench.windows import all_images


def read(run):
    n, span = all_images(run.records)
    return n / span if n and span else None
