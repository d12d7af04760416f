"""The widest gap between the sorted series of each (site, variable) row,
in units of that row's reference standard deviation (ddof 0), over rows
[..., T]: it holds each variable's marginal distribution whatever order
the days take.  NaN sorts last and matches only NaN; a wrong shape, or a
NaN or an infinity against a number, is an infinite gap."""

import numpy as np


def gap(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf")
    g, w = np.sort(got, axis=-1), np.sort(want, axis=-1)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(g - w))
        sd = np.nanstd(w, axis=-1, keepdims=True)
        d = d / np.where(sd > 0, sd, 1.0)
    d = np.where(np.isnan(d), np.inf, d)
    return float(d.max()) if d.size else 0.0
