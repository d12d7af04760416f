"""Small tensor helpers shared by the containers and the ops.

Data arrives as numpy arrays or torch tensors.  A tensor stays on its device;
a numpy array becomes a CPU tensor.  Nothing here picks a device on its own.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "as_tensor",
    "nanmax",
    "nanmin",
    "nanreduce",
    "nanstd",
    "nanvar",
    "numpy_dtype",
    "to_numpy",
]


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a tensor: tensors keep their device unless one is given,
    numpy arrays and scalars become tensors on ``device`` (CPU by default)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype or x.dtype, device=device or x.device)
    a = np.asarray(x)
    if not a.flags.writeable:  # read-only (broadcast views, loaded files): torch wants its own copy
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=device)


def to_numpy(x) -> np.ndarray:
    """Host numpy copy (or view) of a tensor or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype matching a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _dims(x: torch.Tensor, axis):
    if axis is None:
        return tuple(range(x.ndim))
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _count(x: torch.Tensor, axis, keepdims: bool):
    return (~torch.isnan(x)).sum(dim=_dims(x, axis), keepdim=keepdims)


def nanmin(x: torch.Tensor, axis=None, keepdims: bool = False) -> torch.Tensor:
    """NaN-skipping minimum; all-NaN slices give NaN (as ``np.nanmin``)."""
    out = torch.where(torch.isnan(x), torch.inf, x).amin(dim=_dims(x, axis), keepdim=keepdims)
    return torch.where(_count(x, axis, keepdims) == 0, torch.nan, out)


def nanmax(x: torch.Tensor, axis=None, keepdims: bool = False) -> torch.Tensor:
    """NaN-skipping maximum; all-NaN slices give NaN (as ``np.nanmax``)."""
    out = torch.where(torch.isnan(x), -torch.inf, x).amax(dim=_dims(x, axis), keepdim=keepdims)
    return torch.where(_count(x, axis, keepdims) == 0, torch.nan, out)


def nanvar(x: torch.Tensor, axis=None, keepdims: bool = False, ddof: int = 0) -> torch.Tensor:
    """NaN-skipping variance (as ``np.nanvar``)."""
    dims = _dims(x, axis)
    mean = torch.nanmean(x, dim=dims, keepdim=True)
    sq = torch.nansum((x - mean) ** 2, dim=dims, keepdim=keepdims)
    return sq / (_count(x, axis, keepdims) - ddof).to(x.dtype)


def nanstd(x: torch.Tensor, axis=None, keepdims: bool = False, ddof: int = 0) -> torch.Tensor:
    """NaN-skipping standard deviation (as ``np.nanstd``)."""
    return torch.sqrt(nanvar(x, axis, keepdims, ddof))


def _nanmean(x, axis=None, keepdims=False):
    return torch.nanmean(x, dim=_dims(x, axis), keepdim=keepdims)


def _nansum(x, axis=None, keepdims=False):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdims)


_REDUCERS = {"mean": _nanmean, "sum": _nansum, "min": nanmin, "max": nanmax, "std": nanstd, "var": nanvar}


def nanreduce(name: str):
    """The NaN-skipping reduction ``name`` (mean/sum/min/max/std/var) for
    tensors, with numpy's ``(x, axis=...)`` signature."""
    return _REDUCERS[name]
