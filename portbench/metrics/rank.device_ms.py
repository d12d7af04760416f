"""Device time a block spends in QDM's rank of sim, in ms, from the traced
blocks with stacks."""


def read(ctx):
    t = ctx.layer_s("rank")
    return None if t is None else t * 1e3
