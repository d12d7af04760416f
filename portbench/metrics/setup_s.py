"""Seconds from the start of the harness to the window: imports, CUDA
initialisation, building or loading the kernels, the pool of blocks on the
card and the warm-up blocks (host clock)."""


def read(ctx):
    return ctx.setup_s
