"""clips_per_s: clips whose outputs reached the host in the window, over
the window's seconds (the host's clock, from the first batch's issue to the
last batch's landing)."""


def read(ctx):
    return ctx.window.rows / ctx.window.seconds
