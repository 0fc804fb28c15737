"""The program's host_output span (the .hhr hit list and alignments)
per hhsearch query."""

from harness import readings


def read(ctx):
    return readings.span_per_query(ctx, "host_output")
