"""Host milliseconds a block in the port's lowering on the host: its
outermost ``lower.*`` spans (the grouping indexes built, the bracket
partitions of the lookup, the static extraction indices, each with its
uploads), over the public train and adjust calls of the traced run's
blocks without stacks, as the port recorded them."""

from portbench import spans


def _lower_ns(call):
    return sum(s["ns"] for s in call["spans"] if s["name"].startswith("lower.") and not (s["parent"] or "").startswith("lower."))


def read(ctx):
    ns = spans.per_block(ctx, _lower_ns)
    return None if ns is None else ns / 1e6
