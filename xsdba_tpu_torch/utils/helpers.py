"""Small public utilities mirroring reference ``xsdba/utils.py`` helpers.

The port's own copy of the JAX package's ``utils/helpers.py``: cyclic
padding, dayofyear-range alignment, empirical CDF mapping, tie-breaking
noise, 1-D cluster extraction, attribute copying and random rotations.
The empirical-CDF helpers and the tie-break compute on the data's device
(numpy data on the ``device`` option's device); the 1-D forms are host
numpy, as in the reference.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from .container import DataArray, Dataset
from .tensor import as_tensor, input_tensor, to_numpy

__all__ = [
    "add_cyclic_bounds",
    "copy_all_attrs",
    "ecdf",
    "ensure_longest_doy",
    "get_clusters_1d",
    "map_cdf",
    "map_cdf_1d",
    "rand_rot_matrix",
    "random_tiebreak",
]


def add_cyclic_bounds(da: DataArray, att: str, cyclic_coords: bool = True) -> DataArray:
    """Prepend the last slice and append the first along ``att`` so
    interpolation works near the end points (reference ``utils.py:284-314``).
    With ``cyclic_coords=False`` the new coordinate values extrapolate their
    neighbours' step instead of wrapping.  A tensor stays on its device."""
    ax = da.get_axis_num(att)
    data = da.data
    first = [slice(None)] * data.ndim
    last = list(first)
    first[ax] = slice(0, 1)
    last[ax] = slice(-1, None)
    parts = [data[tuple(last)], data, data[tuple(first)]]
    padded = torch.cat(parts, dim=ax) if isinstance(data, torch.Tensor) else np.concatenate([np.asarray(p) for p in parts], axis=ax)
    coords = dict(da.coords)
    if att in coords:
        c = np.asarray(coords[att])
        if cyclic_coords:
            coords[att] = np.concatenate([c[-1:], c, c[:1]])
        else:
            d0 = c[1] - c[0] if len(c) > 1 else 1
            d1 = c[-1] - c[-2] if len(c) > 1 else 1
            coords[att] = np.concatenate([[c[0] - d0], c, [c[-1] + d1]])
    return DataArray(padded, da.dims, coords, dict(da.attrs), da.name)


def ensure_longest_doy(func):
    """Decorator: align two dayofyear-indexed arrays onto the longest
    dayofyear range before calling ``func(x, y, ...)`` (reference
    ``utils.py:108-131``)."""
    from .calendar import interpolate_doy_calendar

    def _align(da: DataArray, mdoy: int, mn: int) -> DataArray:
        ax = da.get_axis_num("dayofyear")
        out = interpolate_doy_calendar(to_numpy(da.data), mdoy, mn, axis=ax)
        coords = dict(da.coords)
        coords["dayofyear"] = np.arange(mn, mdoy + 1)
        return DataArray(out, da.dims, coords, dict(da.attrs), da.name)

    @functools.wraps(func)
    def _wrapped(x, y, *args, **kwargs):
        if "dayofyear" in getattr(x, "dims", ()) and "dayofyear" in getattr(y, "dims", ()):
            dx = np.asarray(x.coords["dayofyear"])
            dy = np.asarray(y.coords["dayofyear"])
            if dx.max() != dy.max():
                warnings.warn(
                    "get_correction received inputs defined on different dayofyear "
                    "ranges. Interpolating to the longest range. Results could be strange.",
                    stacklevel=4,
                )
                if dx.max() < dy.max():
                    x = _align(x, int(dy.max()), int(dy.min()))
                else:
                    y = _align(y, int(dx.max()), int(dx.min()))
        return func(x, y, *args, **kwargs)

    return _wrapped


def map_cdf_1d(x, y, y_value):
    """The value in ``x`` with the same empirical CDF as ``y_value`` in ``y``
    (reference ``utils.py:35-44``); host numpy."""
    x = np.asarray(to_numpy(x), dtype=float)
    y = np.asarray(to_numpy(y), dtype=float)
    sy = np.r_[-np.inf, np.sort(y, axis=None)]
    q = np.searchsorted(sy, y_value, side="right") / np.sum(~np.isnan(sy))
    return np.nanquantile(x, q=q)


def ecdf(x, value, dim: str = "time"):
    """P(X <= value) along ``dim`` (reference ``utils.py:87-105``): a
    DataArray (``dim`` a dimension name) or an array (``dim`` an integer
    axis, else the last)."""
    from ..ops import correction as _corr

    if isinstance(x, DataArray):
        xc = x.move_dim_last(dim)
        out = _corr.ecdf(input_tensor(xc.data), value, axis=-1)
        bdims = xc.dims[:-1]
        return DataArray(out, bdims, {d: xc.coords[d] for d in bdims if d in xc.coords}, {"units": ""}, x.name)
    return _corr.ecdf(input_tensor(x), value, axis=dim if isinstance(dim, int) else -1)


def map_cdf(ds, *, y_value, dim: str = "time"):
    """The value in ``ds.x`` with the same CDF as ``y_value`` in ``ds.y``
    (reference ``utils.py:47-84``): quantile mapping of a threshold, over
    every dimension but ``dim``; the values of ``y_value`` along a new
    last dimension ``x``."""
    from ..ops import correction as _corr

    xc, yc = ds["x"].move_dim_last(dim), ds["y"].move_dim_last(dim)
    xv = input_tensor(xc.data)
    yv = as_tensor(input_tensor(yc.data), device=xv.device)
    values = np.atleast_1d(y_value).astype(float)
    out = torch.stack([_corr.map_cdf(xv, yv, torch.tensor(v, dtype=yv.dtype, device=xv.device), axis=-1) for v in values], dim=-1)
    bdims = xc.dims[:-1]
    return DataArray(out, bdims + ("x",), {d: xc.coords[d] for d in bdims if d in xc.coords}, dict(ds["x"].attrs), ds["x"].name)


def rand_rot_matrix(crd, num: int = 1, new_dim: str | None = None, **kwargs):
    """Random SO(N) rotation matrices (reference ``utils.py:924-975``,
    Mezzadri 2007), from the port's generator stream.  With an integer
    first argument this is ``ops/rotation.py:rand_rot_matrix`` (extra
    keywords pass through); with a coordinate DataArray it returns a float32
    DataArray over ``(crd_dim, new_dim)``, stacked along ``matrices`` when
    ``num > 1``."""
    from ..ops.rotation import rand_rot_matrix as _draw

    if isinstance(crd, (int, np.integer)):
        return _draw(int(crd), num=num, **kwargs)
    vals = np.asarray(crd.data if isinstance(crd, DataArray) else crd)
    dim = crd.dims[0] if isinstance(crd, DataArray) else "crd"
    new_dim = new_dim or dim + "_prime"
    mats = _draw(vals.size, num=num, **kwargs).to(torch.float32)
    coords = {dim: vals, new_dim: vals.copy()}
    attrs = {"crd_dim": dim, "new_dim": new_dim}
    if num > 1:
        return DataArray(mats, ("matrices", dim, new_dim), coords, attrs, "rot_matrices")
    return DataArray(mats, (dim, new_dim), coords, attrs, "rot_matrix")


def random_tiebreak(da: DataArray, dim: str = "time") -> DataArray:
    """Add noise in U(0.1, 0.25) times the smallest nonzero difference
    along ``dim``, which breaks ties without reordering distinct values
    (reference ``utils.py:543-571``); float64, on the data's device.  The
    draws are ``processing._noise_draws``'."""
    from ..processing import _noise_draws

    dac = da.move_dim_last(dim)
    x = as_tensor(input_tensor(dac.data), dtype=torch.float64)
    d = torch.diff(torch.sort(x, dim=-1).values, dim=-1)
    d = d[d > 0]
    min_diff = float(d.min()) if d.numel() else float("nan")
    out = DataArray(x + _noise_draws(x, 0.1 * min_diff, 0.25 * min_diff), dac.dims, dict(dac.coords), dict(da.attrs), da.name)
    return out.transpose(*da.dims) if out.dims != da.dims else out


def get_clusters_1d(data: np.ndarray, u1: float, u2: float):
    """Clusters of a 1-D array: maximal runs above ``u2`` holding at least
    one value above ``u1`` (reference ``utils.py:788-840``; Extremes.jl
    ``getcluster``).  Returns ``(starts, ends, maxpos, maxval)``, ``ends``
    inclusive.  Host numpy: run membership, then segment reductions over
    the runs (``ufunc.reduceat``); a NaN is never a member, so it ends a
    run."""
    x = to_numpy(data)
    member = x > u2
    if not member.any():
        z = np.array([], dtype=np.int64)
        return z, z.copy(), z.copy(), np.array([])
    member_prev = np.concatenate(([False], member[:-1]))
    member_next = np.concatenate((member[1:], [False]))
    first = np.flatnonzero(member & ~member_prev)
    last = np.flatnonzero(member & ~member_next)
    filled = np.where(member, x, -np.inf)
    run_max = np.maximum.reduceat(filled, first)
    # the earliest member position at the run's maximum
    run_of = np.cumsum(member & ~member_prev) - 1
    at_max = member & (filled == run_max[run_of])
    run_maxpos = np.minimum.reduceat(np.where(at_max, np.arange(x.size), x.size), first)
    keep = run_max > u1
    return first[keep], last[keep], run_maxpos[keep], run_max[keep]


def copy_all_attrs(ds, ref):
    """Copy the attributes of ``ref`` onto ``ds``, and those of the
    variables they share (reference ``utils.py:1151-1159``)."""
    ds.attrs.update(ref.attrs)
    if isinstance(ds, Dataset) and isinstance(ref, Dataset):
        for name, var in ds.items():
            if name in ref:
                var.attrs.update(ref[name].attrs)
