"""The lookup layer's share of its roofline, in %: the least time of the
factor lookup on the card (``roofline.lookup_work``) over the device time a
block spends in the layer (the traced blocks with stacks); nothing where
the grouping has no roofline formula."""

from portbench import roofline


def read(ctx):
    t, shapes = ctx.layer_s("lookup"), ctx.shapes()
    if t is None or shapes is None:
        return None
    return 100 * roofline.bound_s(*roofline.lookup_work(shapes))[0] / t
