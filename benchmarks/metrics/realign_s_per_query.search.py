"""The program's host_realign span (MAC realignment) per hhsearch query."""

from harness import readings


def read(ctx):
    return readings.span_per_query(ctx, "host_realign")
