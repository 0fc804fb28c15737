"""The program's vit_light_hits span (the path-less hits the funnel
makes of the templates it does not backtrace) per hhsearch query."""

from harness import readings


def read(ctx):
    return readings.span_per_query(ctx, "vit_light_hits")
