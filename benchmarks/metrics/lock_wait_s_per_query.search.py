"""Seconds the queries waited for the program's shared locks (the
database's, the resident pack's, the database cache's) per hhsearch
query.  The program writes ``lock_wait`` only when a query waited, so a
run whose queries were timed (``hhsearch_query``) and never waited reads
0."""

from harness import readings


def read(ctx):
    timers = ctx["timers"]
    if "lock_wait" not in timers and "hhsearch_query" in timers:
        timers = dict(timers, lock_wait=0.0)
    return readings.span_per_query(dict(ctx, timers=timers), "lock_wait")
