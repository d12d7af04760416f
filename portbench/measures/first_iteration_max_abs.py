"""The widest |got - want| of the first iteration of trained factors
[sites, groups, iterations, V, nq] (MBCn's ``af_q``): the first rotation's
factors, computed before float32 and float64 trajectories can part.  A
wrong shape is an infinite gap; NaN and infinities as in ``max_abs``."""

import numpy as np

from .max_abs import gap as max_abs


def gap(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.ndim != 5:
        return float("inf")
    return max_abs(got[:, :, 0], want[:, :, 0])
