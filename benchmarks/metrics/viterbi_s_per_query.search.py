"""The program's viterbi_search span per hhsearch query."""

from harness import readings


def read(ctx):
    return readings.span_per_query(ctx, "viterbi_search")
