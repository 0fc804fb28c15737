"""Seconds of the program's host_template_prep span during set-up."""


def read(ctx):
    return ctx["setup_timers"].get("host_template_prep")
