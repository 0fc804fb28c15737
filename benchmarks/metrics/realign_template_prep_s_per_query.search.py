"""The program's realign_template_prep span (the realigned templates'
fetch and transitions) per hhsearch query."""

from harness import readings


def read(ctx):
    return readings.span_per_query(ctx, "realign_template_prep")
