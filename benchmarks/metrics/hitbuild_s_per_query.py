"""The program's host_hitbuild span (decode and rescoring, SS in Python)
per hhsearch query."""

from harness import readings


def read(ctx):
    return readings.span_per_query(ctx, "host_hitbuild")
