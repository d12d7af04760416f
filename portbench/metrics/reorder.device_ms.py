"""Device time a block spends in the Schaake reordering of MBCn's adjust,
in ms, from the traced blocks with stacks."""


def read(ctx):
    t = ctx.layer_s("reorder")
    return None if t is None else t * 1e3
