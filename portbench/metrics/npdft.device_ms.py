"""Device time a block spends in MBCn's npdf transform (the rotations of
train and adjust), in ms, from the traced blocks with stacks."""


def read(ctx):
    t = ctx.layer_s("npdft")
    return None if t is None else t * 1e3
