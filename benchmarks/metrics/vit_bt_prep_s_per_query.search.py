"""The program's vit_bt_prep span (each backtrace batch's inputs: the
pack's gather, exclusion bands, the SS table) per hhsearch query."""

from harness import readings


def read(ctx):
    return readings.span_per_query(ctx, "vit_bt_prep")
