"""Percent of the traced time with no device operation, hhsearch cells."""

from harness import readings


def read(ctx):
    return readings.idle_share(ctx)
