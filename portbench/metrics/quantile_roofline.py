"""The quantile layer's share of its roofline, in %: the least time of the
grouped quantiles of ref and hist on the card (``roofline.quantile_work``)
over the device time a block spends in the layer (the traced blocks with
stacks; on windowed groupings the merge engine is inside it); nothing
where the grouping has no roofline formula."""

from portbench import roofline


def read(ctx):
    t, shapes = ctx.layer_s("quantile"), ctx.shapes()
    if t is None or shapes is None:
        return None
    return 100 * roofline.bound_s(*roofline.quantile_work(shapes))[0] / t
