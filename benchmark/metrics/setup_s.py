"""Seconds from the start of the run to the start of the window: imports,
the card's context, inputs made from the seed, builds and warm-up."""


def read(ctx):
    return ctx.counters.get("setup_s")
