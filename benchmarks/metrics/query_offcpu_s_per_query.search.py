"""Seconds a query's thread held no CPU inside its hhsearch_query span
(waiting for the GIL, the shared locks or the device): the span's wall
seconds less its CPU seconds, per hhsearch query."""


def read(ctx):
    timers, n = ctx["timers"], len(ctx["all"])
    if not n or "hhsearch_query:cpu" not in timers:
        return None
    return (timers["hhsearch_query"] - timers["hhsearch_query:cpu"]) / n
