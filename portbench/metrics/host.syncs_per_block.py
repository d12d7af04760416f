"""Host synchronisations a block: the port's ``sync.*`` counters (each a
place where it reads tensor values to the host, which on the card waits
for the stream) over the public train and adjust calls of the traced run's
blocks without stacks."""

from portbench import spans


def read(ctx):
    return spans.per_block(ctx, lambda c: sum(v for k, v in c["counters"].items() if k.startswith("sync.")))
