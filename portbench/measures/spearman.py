"""The widest gap between the Spearman rank correlations of each pair of
variables at a site, over rows [sites, V, T]: it holds the dependence
between the variables, which is what a multivariate adjustment is for.
Ties take their average rank.  A wrong shape, or a row with a NaN, is an
infinite gap."""

import numpy as np
from scipy.stats import rankdata


def correlations(x: np.ndarray) -> np.ndarray:
    """[sites, V * (V - 1) / 2] Spearman correlations of the pairs i < j."""
    r = rankdata(x, method="average", axis=-1)
    r = r - r.mean(axis=-1, keepdims=True)
    c = np.einsum("svt,swt->svw", r, r)
    d = np.sqrt(np.einsum("svv->sv", c))
    i, j = np.triu_indices(x.shape[1], 1)
    return c[:, i, j] / (d[:, i] * d[:, j])


def gap(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or got.ndim != 3 or np.isnan(got).any() or np.isnan(want).any():
        return float("inf")
    with np.errstate(invalid="ignore", divide="ignore"):
        d = np.abs(correlations(got) - correlations(want))
    d = np.where(np.isnan(d), np.inf, d)
    return float(d.max()) if d.size else 0.0
