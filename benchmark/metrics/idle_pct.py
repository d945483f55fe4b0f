"""Share of the traced window in which no kernel, copy or memset ran on
the card, in percent."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.devices():
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
