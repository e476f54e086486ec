"""setup_s: from the harness's first line to the window's start: importing
torch and the program, building its kernels on a checkout's first run,
making the pool and the weights on the card, warming up every shape."""


def read(ctx):
    return ctx.setup_s
