"""95th percentile of an hhsearch query's seconds in the window, output
written."""

from harness import readings


def read(ctx):
    return readings.latency_p95(ctx)
