"""hhsearch queries completed in the window per second (readings.rate)."""

from harness import readings


def read(ctx):
    return readings.rate(ctx)
