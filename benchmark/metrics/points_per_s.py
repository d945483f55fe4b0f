"""Points of every unit completed in the window, over the window's time."""


def read(ctx):
    c = ctx.counters
    if "window_s" not in c:
        return None
    return c["units"] * c["points_per_unit"] / c["window_s"]
