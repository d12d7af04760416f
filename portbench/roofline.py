"""The least time a layer's work could take on one H100, from shapes alone.

A layer's bound is the larger of two times against the published peaks
of the NVIDIA H100 SXM (NVIDIA's data sheet; they assume the full 700 W
power limit, and the harness prints the card's limit beside every share):

- bytes over 3.35 TB/s of HBM3: each input value read once and each
  output value written once, whatever an implementation reads again;
- comparisons over 67 TFLOP/s, the float32 rate outside the tensor cores,
  counting one comparison as one operation: the work these inputs need,
  not what an implementation does.

The counts come from the configuration and the mix (``shapes``), never
from the program, so that a rewrite of a layer leaves them true.
"""

from __future__ import annotations

import math

import numpy as np

from .reference import calendar

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least seconds, which of "bytes" and "comparisons" sets it)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "comparisons")


def shapes(config: dict, mix: dict, days: dict) -> dict | None:
    """The sizes a block of this configuration and mix works on (``days``:
    the training and sim periods' calendars), or None where the grouping
    has no formula here: its roofline metrics then read nothing."""
    train = days["train"]
    group, window = config["train"].get("group"), int(config["train"].get("window", 1))
    if group == "time" and window == 1:
        sizes = np.array([train.n])
    elif group == "time.month" and window == 1:
        sizes = np.array([len(m) for m in calendar.month_members(train)])
    elif group == "time.dayofyear":
        sizes = (calendar.window_members(train, window) >= 0).sum(axis=1)
    else:
        return None
    return {
        "sites": int(mix["sites_per_block"]),
        "train_days": train.n,
        "sim_days": days["sim"].n,
        "group_sizes": sizes,
        "window": window,
        "nquantiles": int(config["train"]["nquantiles"]),
        "blended": group == "time.month",
        "rank_lookup": config["class"] == "QuantileDeltaMapping",
        "itemsize": np.dtype(config["dtype"]).itemsize,
    }


def quantile_work(s: dict) -> tuple[float, float]:
    """(bytes, comparisons) of the grouped quantiles of ref and hist: read
    both series once, write both tables once; order each group's members,
    n log2 n for a group of n, or, where groups overlap (a rolling window
    holds each day in ``window`` groups), order the series once, T log2 T,
    whichever is less: every group's order follows from the series'."""
    rows, t, n = 2 * s["sites"], s["train_days"], s["group_sizes"].astype(np.float64)
    n_bytes = rows * (t + len(n) * s["nquantiles"]) * s["itemsize"]
    per_row = min(float(np.sum(n * np.log2(np.maximum(n, 2)))), t * math.log2(t))
    return n_bytes, rows * per_row


def lookup_work(s: dict) -> tuple[float, float]:
    """(bytes, comparisons) of the factor lookup: read each value (sim, or
    its rank for QDM) once and write its factor once, read the tables once
    (the factors, and hist's quantiles where sim's values are looked up;
    QDM's nodes are one shared row); a binary search of the nq nodes,
    log2 nq comparisons, in each of the tables a value is looked up in
    (two bracketing months, one day of year)."""
    g, nq, t = len(s["group_sizes"]), s["nquantiles"], s["sim_days"]
    tables = g * nq * (1 if s["rank_lookup"] else 2)
    n_bytes = (s["sites"] * (2 * t + tables) + (nq if s["rank_lookup"] else 0)) * s["itemsize"]
    return n_bytes, s["sites"] * t * math.log2(nq) * (2 if s["blended"] else 1)
