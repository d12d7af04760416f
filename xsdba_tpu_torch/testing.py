"""Synthetic-data factories for tests and examples (reference
``testing/helpers.py``, ``testing/sdba_utils.py``).  They build numpy data
(from the same seed, the JAX package's factories give the same arrays); the
public entry points move it to the ``device`` option's device."""

from __future__ import annotations

import numpy as np
from scipy import stats

from .ops.correction import equally_spaced_nodes
from .utils.calendar import date_range
from .utils.container import DataArray

__all__ = ["cannon_2015_dist", "cannon_2015_rvs", "nancov", "synth_rainfall", "timelonlatseries", "timeseries"]


def timeseries(values, name: str = "tas", start: str = "2000-01-01", units: str | None = None, freq: str = "D", calendar: str = "standard") -> DataArray:
    """1-D daily series factory (reference testing/helpers.py:48-113)."""
    values = np.asarray(values)
    t = date_range(start, periods=values.shape[-1], freq=freq, calendar=calendar)
    if units is None:
        units = {"tas": "K", "tasmax": "K", "tasmin": "K", "pr": "kg m-2 s-1"}.get(name, "")
    attrs = {"units": units}
    if name in ("tas", "tasmax", "tasmin"):
        attrs["kind"] = "+"
    elif name == "pr":
        attrs["kind"] = "*"
    return DataArray(values, ("time",), {"time": t}, attrs, name)


def timelonlatseries(values, name: str = "tas", start: str = "2000-01-01") -> DataArray:
    """[time(, lon, lat)] series factory (reference testing/sdba_utils.py:17-64)."""
    values = np.asarray(values)
    dims = ("time", "lon", "lat")[: values.ndim]
    t = date_range(start, periods=values.shape[0], freq="D")
    coords = {"time": t}
    for i, d in enumerate(dims[1:], start=1):
        coords[d] = np.arange(values.shape[i])
    if name == "tas":
        attrs = {"standard_name": "air_temperature", "units": "K", "kind": "+"}
    elif name == "pr":
        attrs = {"standard_name": "precipitation_flux", "units": "kg m-2 s-1", "kind": "*"}
    else:  # the reference supports exactly these two (sdba_utils.py:42-57)
        raise ValueError(f"Name `{name}` not supported.")
    return DataArray(values, dims, coords, attrs, name)


def cannon_2015_dist():
    """The three gamma distributions of Cannon et al. 2015 (reference
    testing/sdba_utils.py:68-86): ref G(4, 7.5), hist G(8.15, 3.68),
    sim G(16, 2.63)."""
    return stats.gamma(4, scale=7.5), stats.gamma(8.15, scale=3.68), stats.gamma(16, scale=2.63)


def cannon_2015_rvs(n: int, random: bool = True, seed: int | None = None):
    """Draws (or deterministic quantile samples) from the Cannon 2015
    distributions, as 'pr' DataArrays (reference testing/sdba_utils.py:88-114)."""
    dists = cannon_2015_dist()
    if random:
        rng = np.random.default_rng(seed)
        r = [d.rvs(n, random_state=rng) for d in dists]
    else:
        u = equally_spaced_nodes(n, None)
        r = [d.ppf(u) for d in dists]
    return [timelonlatseries(v, "pr") for v in r]


def nancov(X):
    """np.cov dropping any observation with NaNs (reference
    tests/test_adjustment.py:54-57)."""
    X = np.asarray(X)
    mask = np.isnan(X).any(axis=0)
    return np.cov(X[:, ~mask])


def synth_rainfall(shape: float, scale: float = 1.0, wet_freq: float = 0.25, size: int = 1, seed: int | None = None):
    """Gamma-distributed rainfall on wet days, zero on dry days (reference
    testing/diagnostics.py:34-69): Bernoulli(wet_freq) wet mask times
    Gamma(shape, scale) intensities."""
    rng = np.random.default_rng(seed)
    is_wet = rng.binomial(1, p=wet_freq, size=size)
    return np.where(is_wet, rng.gamma(shape, scale, size), 0.0)
