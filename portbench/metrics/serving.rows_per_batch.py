"""Requests a ``generate_batch`` call of the Batcher carried in the window:
``Batcher.stats`` batched_requests over batches, counted from the window's
start."""


def read(run):
    s = run.batcher_stats
    return s["batched_requests"] / s["batches"] if s and s.get("batches") else None
