"""The 95th percentile (linear between order statistics) of the blocks'
wall times in the window, each from the start of its train to the
synchronisation after its adjust (host clock), in ms."""

import numpy as np


def read(ctx):
    if not ctx.block_s:
        return None
    return float(np.percentile(np.asarray(ctx.block_s) * 1e3, 95))
