"""Plain quantile mapping: EQM and QDM train + adjust, site by site.

The semantics the port states for ``EmpiricalQuantileMapping`` and
``QuantileDeltaMapping`` (``train(ref, hist, group=..., nquantiles=...,
kind=...)`` then ``adjust(sim, interp="linear", extrapolation="constant")``),
written out in NumPy float64 from the calendar up, with no code or data of
the port:

- groups: the whole series (``"time"``), a month, or a day of year with a
  centred rolling window of ``window`` days (members outside the series
  are left out);
- quantiles: type 7 (``numpy.quantile``'s "linear") of each group's valid
  (not NaN) members at the bin-midpoint nodes ``(k + 0.5) / nquantiles``;
  a group with none gives NaN;
- factors: ``ref_q - hist_q`` (kind ``"+"``) or ``ref_q / hist_q``
  (kind ``"*"``);
- QDM's rank: each sim value's average rank among its group's valid
  values (the group without window, over sim's own days) divided by their
  count, then rescaled so that the lowest is 0 and the highest keeps its
  value; NaN stays NaN;
- lookup: the factor at the value (EQM: sim against ``hist_q``; QDM: the
  rank against the nodes), linear between nodes and constant beyond the
  first and last, NaN for a NaN value or table; a month blends the
  lookups in the two months whose centres bracket the day, by the day's
  position ``month - 0.5 + day / days_in_month`` between them (December
  before January and January after December); a day of year looks up its
  own group alone;
- ``scen = sim + factor`` or ``sim * factor``.

``rnd`` rounds each stage's result (inputs, quantile tables, factors,
ranks, looked-up factors, scen); the identity gives the float64 reference,
and :func:`bfloat16` the control the comparison has to reject.  Sites are
worked in blocks of :data:`BLOCK_SITES`, so that a day-of-year window's
gathered members fit in memory.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import rankdata

from .calendar import Days, doy_members, month_members, window_members

#: sites a block of the reference works at once
BLOCK_SITES = 4


def identity(x):
    return x


def bfloat16(x):
    """``x`` rounded to bfloat16 (to nearest, ties to even), as float64."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32).astype(np.float64)


def nodes(nquantiles: int) -> np.ndarray:
    return (np.arange(nquantiles) + 0.5) / nquantiles


def _padded(members: list[np.ndarray]) -> np.ndarray:
    out = np.full((len(members), max(len(m) for m in members)), -1, dtype=np.int64)
    for g, m in enumerate(members):
        out[g, : len(m)] = m
    return out


def group_quantiles(x: np.ndarray, members: np.ndarray, q: np.ndarray, rnd=identity) -> np.ndarray:
    """Type-7 quantiles [S, G, nq] of x [S, T] over each group's valid
    members (``members`` [G, L], -1 for none)."""
    padded = np.concatenate([x, np.full(x.shape[:-1] + (1,), np.nan)], axis=-1)
    vals = np.sort(padded[:, np.where(members >= 0, members, x.shape[-1])], axis=-1)   # NaN last
    if np.isnan(x).any():
        n = (~np.isnan(vals)).sum(axis=-1)              # [S, G]
    else:
        n = np.broadcast_to((members >= 0).sum(axis=-1), vals.shape[:-1])
    h = (np.maximum(n, 1)[..., None] - 1) * q           # [S, G, nq]
    lo = np.floor(h).astype(np.int64)
    hi = np.minimum(lo + 1, np.maximum(n, 1)[..., None] - 1)
    g = h - lo
    v_lo = np.take_along_axis(vals, lo, axis=-1)
    v_hi = np.take_along_axis(vals, hi, axis=-1)
    out = v_lo + g * (v_hi - v_lo)
    return rnd(np.where(n[..., None] > 0, out, np.nan))


def pct_ranks(x: np.ndarray, groups: list[np.ndarray], rnd=identity) -> np.ndarray:
    """Rescaled percent ranks [S, T] of x [S, T] within each group; NaN
    stays NaN and is not counted."""
    out = np.full_like(x, np.nan)
    for idx in groups:
        v = x[:, idx]
        nan = np.isnan(v)
        r = rankdata(np.where(nan, np.inf, v), method="average", axis=1) / np.maximum((~nan).sum(axis=1, keepdims=True), 1)
        r = np.where(nan, np.nan, r)
        with np.errstate(invalid="ignore"):
            mn, mx = np.nanmin(np.where(nan, np.inf, r), axis=1, keepdims=True), np.nanmax(np.where(nan, -np.inf, r), axis=1, keepdims=True)
            out[:, idx] = np.where(mx == mn, np.where(nan, np.nan, 0.0), mx * (r - mn) / np.where(mx == mn, 1.0, mx - mn))
    return rnd(out)


def lookup(v: np.ndarray, xq: np.ndarray, yq: np.ndarray, g: np.ndarray) -> np.ndarray:
    """y at v [S, T] on the table of group g[t] (xq, yq [S, G, nq]):
    linear between nodes, constant beyond them, NaN for a NaN value or a
    table with NaN."""
    out = np.full_like(v, np.nan)
    for k in np.unique(g):
        sel = np.flatnonzero(g == k)
        for s in range(v.shape[0]):
            if np.isnan(xq[s, k]).any() or np.isnan(yq[s, k]).any():
                continue
            out[s, sel] = np.interp(v[s, sel], xq[s, k], yq[s, k])
    return np.where(np.isnan(v), np.nan, out)


def month_brackets(days: Days):
    """(g0, g1, w) per day: the months (0..11) whose centres bracket the
    day and the weight of the later one."""
    frac = days.month - 0.5 + days.day / days.month_len
    p0 = np.floor(frac).astype(np.int64)                # 0 (December before) .. 12
    w = frac - p0
    return (p0 - 1) % 12, p0 % 12, w


def _groups(train: dict, train_days: Days, sim_days: Days):
    """(members [G, L] of the training days, sim's rank groups, g0, g1, w)."""
    group, window = train["group"], int(train.get("window", 1))
    if group == "time" and window == 1:
        zero = np.zeros(sim_days.n, dtype=np.int64)
        return np.arange(train_days.n)[None, :], [np.arange(sim_days.n)], zero, zero, np.zeros(sim_days.n)
    if group == "time.month" and window == 1:
        return _padded(month_members(train_days)), month_members(sim_days), *month_brackets(sim_days)
    if group == "time.dayofyear":
        members = window_members(train_days, window) if window > 1 else _padded(doy_members(train_days))
        g = sim_days.doy - 1
        return members, doy_members(sim_days), g, g, np.zeros(sim_days.n)
    raise NotImplementedError(f"the plain reference has no grouping {group!r} with window {window}")


def _block(config: dict, ref, hist, sim, grouping, rnd) -> dict:
    train = config["train"]
    members, rank_groups, g0, g1, w = grouping
    mul = train.get("kind", "+") == "*"
    q = nodes(int(train["nquantiles"]))
    ref_q = group_quantiles(ref, members, q, rnd)
    hist_q = group_quantiles(hist, members, q, rnd)
    with np.errstate(divide="ignore", invalid="ignore"):
        af = rnd(ref_q / hist_q if mul else ref_q - hist_q)
    if config["class"] == "QuantileDeltaMapping":
        v = pct_ranks(sim, rank_groups, rnd)
        xq = np.broadcast_to(q, af.shape)
    elif config["class"] == "EmpiricalQuantileMapping":
        v, xq = sim, hist_q
    else:
        raise NotImplementedError(config["class"])
    af_t = lookup(v, xq, af, g0)
    if np.any(w > 0):
        af_t = (1 - w) * af_t + w * lookup(v, xq, af, g1)
    af_t = rnd(af_t)
    return {"scen": rnd(sim * af_t if mul else sim + af_t), "af": af, "hist_q": hist_q}


def train_adjust(config: dict, inputs: dict, days: dict, rnd=identity) -> dict:
    """{output: rows} of ``config``'s train + adjust on the site rows
    ``inputs`` (ref, hist [S, T_train], sim [S, T_sim]) over ``days``
    (``train``, ``sim``): ``scen`` [S, T_sim], ``af`` and ``hist_q``
    [S, G, nq]."""
    adjust = config["adjust"]
    if (adjust["interp"], adjust["extrapolation"]) != ("linear", "constant"):
        raise NotImplementedError("the plain reference covers linear interpolation and constant extrapolation")
    if config["train"].get("kind", "+") not in ("+", "*"):
        raise NotImplementedError(f"kind {config['train']['kind']!r}")
    ref, hist, sim = (rnd(np.asarray(inputs[k], dtype=np.float64)) for k in ("ref", "hist", "sim"))
    grouping = _groups(config["train"], days["train"], days["sim"])
    parts = [_block(config, ref[i : i + BLOCK_SITES], hist[i : i + BLOCK_SITES], sim[i : i + BLOCK_SITES], grouping, rnd)
             for i in range(0, ref.shape[0], BLOCK_SITES)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
