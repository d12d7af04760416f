"""The share of the traced window (the blocks profiled without stacks) in
which no kernel, copy or fill ran on the card, in %."""


def read(ctx):
    if not ctx.trace or not ctx.trace["window_s"]:
        return None
    return 100 * (1 - ctx.trace["busy_s"] / ctx.trace["window_s"])
