"""What the port recorded of its own public calls while the profiler ran
(``xsdba_tpu_torch.utils.profiling``: spans and counter deltas of each
outermost call), for the readers of the port's host work (``metrics/host.*.py``)."""

from __future__ import annotations


def block_pairs(ctx) -> list[tuple[dict, dict]] | None:
    """The first ``ctx.trace["blocks"]`` (train, adjust) pairs of public
    calls the port kept, in order: the blocks of the traced run's capture
    without stacks, which runs first.  None without such a capture (on the
    CPU), where the port keeps no calls, or where it kept fewer pairs."""
    if not ctx.trace or not ctx.trace.get("blocks"):
        return None
    from xsdba_tpu_torch.utils import profiling

    calls = getattr(profiling, "calls", None)
    if calls is None:
        return None
    recs, pairs, i = calls(), [], 0
    n = int(ctx.trace["blocks"])
    while i + 1 < len(recs) and len(pairs) < n:
        if recs[i]["name"] == "train" and recs[i + 1]["name"] == "adjust":
            pairs.append((recs[i], recs[i + 1]))
            i += 2
        else:
            i += 1
    return pairs if len(pairs) == n else None


def per_block(ctx, value) -> float | None:
    """The mean over the block pairs of ``value(call)`` summed over each
    pair's train and adjust, or None where :func:`block_pairs` is."""
    pairs = block_pairs(ctx)
    if pairs is None:
        return None
    return sum(value(c) for pair in pairs for c in pair) / len(pairs)
