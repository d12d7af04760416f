"""The reference's ``xsdba.nbutils`` import path.

The reference's numba kernels map to tensor operators here: the type-7
NaN-quantiles and the per-element quantiles are ``ops/quantile.py`` (a sort
and the virtual-index lerp).  The JAX package runs them eagerly, so its
type-7 arithmetic is rounded unfused, and these calls ask for the same
(``fused=False``, ROADMAP C11).  Numpy data goes to the ``device`` option's
device; a tensor stays on its own.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.quantile import nan_quantile
from .ops.quantile import vecquantiles as _vecquantiles
from .utils.container import DataArray
from .utils.tensor import input_tensor

__all__ = ["quantile", "remove_NaNs", "vecquantiles"]


def _dims_of(dim):
    return (dim,) if isinstance(dim, str) else tuple(dim)


def remove_NaNs(x):  # noqa: N802 - reference name (nbutils.py:283-288)
    """Drop the samples (columns of a [variables, time] array) where any
    variable is NaN; a tensor stays a tensor on its device, anything else
    becomes a numpy array."""
    if isinstance(x, torch.Tensor):
        return x[:, ~torch.isnan(x).any(dim=0)]
    x = np.asarray(x)
    return x[:, ~np.isnan(x).any(axis=0)]


def quantile(da, q, dim):
    """Type-7 NaN-quantiles of ``da`` along ``dim`` (reference
    nbutils.py:224-280).  Takes a DataArray (returns one, with a trailing
    ``quantiles`` dimension; ``dim`` may name several dimensions) or a bare
    array with ``dim`` an axis index (returns a tensor)."""
    q = np.atleast_1d(np.asarray(q, dtype=np.float64))
    if isinstance(da, DataArray):
        dims = _dims_of(dim)
        axes = [da.dims.index(d) for d in dims]
        x = input_tensor(da.data)
        if len(axes) > 1:  # the reduced dims flattened into one trailing axis
            keep = [i for i in range(x.ndim) if i not in axes]
            x = x.permute(*keep, *axes).reshape(*(x.shape[i] for i in keep), -1)
            axis = -1
        else:
            axis = axes[0]
        out = nan_quantile(x, q, axis=axis, fused=False)
        kept = tuple(d for d in da.dims if d not in dims)
        coords = {d: c for d, c in da.coords.items() if d in kept}
        coords["quantiles"] = q
        return DataArray(out, kept + ("quantiles",), coords, dict(da.attrs), da.name)
    if not isinstance(dim, int):
        raise TypeError(
            f"quantile on a bare array needs an integer axis, got dim={dim!r} "
            "(wrap the array in a DataArray to reduce by dimension name)."
        )
    return nan_quantile(input_tensor(da), q, axis=dim, fused=False)


def vecquantiles(da, rnk, dim):
    """Per-element quantile extraction: for each position of ``rnk``, the
    ``rnk``-th quantile of ``da`` along ``dim`` (reference
    nbutils.py:157-196)."""
    if isinstance(da, DataArray):
        (axis,) = (da.dims.index(d) for d in _dims_of(dim))
        ranks = rnk.data if isinstance(rnk, DataArray) else rnk
        out = _vecquantiles(input_tensor(da.data), ranks, axis=axis, fused=False)
        kept = tuple(d for d in da.dims if d != dim)
        coords = {d: c for d, c in da.coords.items() if d in kept}
        return DataArray(out, kept, coords, dict(da.attrs), da.name)
    if not isinstance(dim, int):
        raise TypeError(
            f"vecquantiles on a bare array needs an integer axis, got dim={dim!r} "
            "(wrap the array in a DataArray to reduce by dimension name)."
        )
    return _vecquantiles(input_tensor(da), rnk, axis=dim, fused=False)
