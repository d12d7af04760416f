"""Median host time of the public train call of the traced run's window,
synchronised after the call, in ms."""

import statistics


def read(ctx):
    return statistics.median(ctx.api_ms["train"]) if ctx.api_ms["train"] else None
