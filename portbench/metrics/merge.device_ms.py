"""Device time a block spends in the merge engine (K3, K5, K6 or K4), in
ms, from the traced blocks with stacks."""


def read(ctx):
    t = ctx.layer_s("merge")
    return None if t is None else t * 1e3
