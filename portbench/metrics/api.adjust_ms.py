"""Median host time of the public adjust call of the traced run's window,
from the synchronisation after train to the one after adjust, in ms."""

import statistics


def read(ctx):
    return statistics.median(ctx.api_ms["adjust"]) if ctx.api_ms["adjust"] else None
