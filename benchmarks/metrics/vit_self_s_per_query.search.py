"""viterbi_search's own seconds, outside its child spans (the funnel's
bookkeeping, the sweep's chunking and gathers, the query's upload), per
hhsearch query."""

from harness import readings


def read(ctx):
    return readings.span_per_query(ctx, "viterbi_search:self")
