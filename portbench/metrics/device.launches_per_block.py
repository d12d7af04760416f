"""Kernels launched a block, counted in the trace of the blocks profiled
without stacks."""


def read(ctx):
    if not ctx.trace or not ctx.trace["blocks"] or not ctx.trace["kernels"]:
        return None
    return ctx.trace["kernels"] / ctx.trace["blocks"]
