"""The widest |got - want| over the rows compared.  A NaN or an infinity
matches only its like at the same place (0 there); anywhere else it is
an infinite gap."""

import numpy as np


def gap(got: np.ndarray, want: np.ndarray) -> float:
    got, want = got.astype(np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf")
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(got - want))
    d = np.where(np.isnan(d), np.inf, d)
    return float(d.max()) if d.size else 0.0
