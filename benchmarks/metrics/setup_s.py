"""Seconds from the process's start to the window's: imports, the database
(its one-time build not counted), its open and the warm-up queries."""


def read(ctx):
    return ctx["setup_s"]
