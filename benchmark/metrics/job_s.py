"""The window's time over the jobs it completed: the window ends when the
last job it started has finished."""


def read(ctx):
    c = ctx.counters
    if "window_s" not in c or not c["units"]:
        return None
    return c["window_s"] / c["units"]
