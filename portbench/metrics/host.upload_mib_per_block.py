"""MiB of host arrays the port copied to the device a block: its
``upload.bytes`` counter over the public train and adjust calls of the
traced run's blocks without stacks."""

from portbench import spans


def read(ctx):
    b = spans.per_block(ctx, lambda c: c["counters"].get("upload.bytes", 0))
    return None if b is None else b / 2**20
