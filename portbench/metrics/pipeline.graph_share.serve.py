"""The share of the window's UNet visits that the pipeline replayed from a
CUDA graph: ``Batcher.stats`` graph_visits over unet_visits, counted from
the window's start, %. None where the program does not count them."""


def read(run):
    s = run.batcher_stats
    if not s or not s.get("unet_visits") or "graph_visits" not in s:
        return None
    return 100.0 * s["graph_visits"] / s["unet_visits"]
