"""Milliseconds a cold template build during set-up: the program's
template_build span (a3m to prepared template) over its
n:template_builds count."""


def read(ctx):
    timers = ctx["setup_timers"]
    n = timers.get("n:template_builds")
    if "template_build" not in timers or not n:
        return None
    return 1e3 * timers["template_build"] / n
