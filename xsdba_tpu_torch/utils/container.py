"""Thin host-side labeled-array shell.

The reference rides on xarray for labels/attrs/metadata; here the xarray role
is reduced to a deliberately small host shell: a :class:`DataArray` is a dense
numpy array or torch tensor + dims + coords (with ``time`` being a
:class:`~xsdba_tpu_torch.utils.calendar.TimeIndex`) + attrs.  All heavy compute
takes raw tensors; these containers only carry metadata in and out.  A tensor
stays on the device it was given on.

Not a general xarray clone: only the operations the bias-adjustment API needs
(alignment of the time axis, unit/history attrs, variable stacking).
"""

from __future__ import annotations

import numpy as np
import torch

from .calendar import TimeIndex
from .tensor import nanreduce, to_numpy

__all__ = ["DataArray", "Dataset"]


def _date_key(s, end: bool) -> int:
    """YYYYMMDD integer for a (possibly partial) date-string bound: missing
    components fill to the period start (``end=False``) or end (``end=True``,
    day 31 compares correctly as an upper bound in key space)."""
    parts = str(s).split("-")
    y = int(parts[0])
    m = int(parts[1]) if len(parts) > 1 else (12 if end else 1)
    d = int(parts[2]) if len(parts) > 2 else (31 if end else 1)
    return y * 10000 + m * 100 + d


def _asarray(data):
    if isinstance(data, (np.ndarray, torch.Tensor)):
        return data
    return np.asarray(data)


class DataArray:
    """A labeled dense array: ``data`` [dims...], ``coords`` per dim, ``attrs``."""

    __slots__ = ("data", "dims", "coords", "attrs", "name")

    def __init__(self, data, dims=None, coords=None, attrs=None, name=None):
        self.data = _asarray(data)
        if dims is None:
            if self.data.ndim == 1:
                dims = ("time",)
            else:
                raise ValueError("dims required for ndim != 1")
        self.dims = tuple(dims)
        if len(self.dims) != self.data.ndim:
            raise ValueError(f"dims {self.dims} don't match shape {self.data.shape}")
        self.coords = dict(coords or {})
        self.attrs = dict(attrs or {})
        self.name = name

    # -- basic introspection ----------------------------------------------

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.data.shape))

    @property
    def time(self) -> TimeIndex | None:
        return self.coords.get("time")

    @property
    def units(self) -> str:
        return self.attrs.get("units", "")

    def get_axis_num(self, dim: str) -> int:
        return self.dims.index(dim)

    def __len__(self):
        return self.data.shape[0]

    def __repr__(self):
        coords = ", ".join(self.coords)
        return f"<xsdba_tpu_torch.DataArray {self.name or ''}{self.sizes} coords=({coords}) attrs={self.attrs}>"

    # -- manipulation ------------------------------------------------------

    def copy(self, data=None, attrs=None) -> "DataArray":
        return DataArray(
            self.data if data is None else data,
            self.dims,
            dict(self.coords),
            dict(self.attrs) if attrs is None else dict(attrs),
            self.name,
        )

    def assign_attrs(self, **kw) -> "DataArray":
        out = self.copy()
        out.attrs.update(kw)
        return out

    def rename(self, name: str) -> "DataArray":
        out = self.copy()
        out.name = name
        return out

    def transpose(self, *dims) -> "DataArray":
        order = [self.dims.index(d) for d in dims]
        data = np.transpose(self.data, order) if isinstance(self.data, np.ndarray) else self.data.permute(order)
        return DataArray(data, dims, dict(self.coords), dict(self.attrs), self.name)

    def move_dim_last(self, dim: str) -> "DataArray":
        """Return a view with ``dim`` as the trailing axis (compute layout)."""
        ax = self.dims.index(dim)
        if ax == self.ndim - 1:
            return self
        data = np.moveaxis(self.data, ax, -1) if isinstance(self.data, np.ndarray) else torch.movedim(self.data, ax, -1)
        dims = tuple(d for d in self.dims if d != dim) + (dim,)
        return DataArray(data, dims, dict(self.coords), dict(self.attrs), self.name)

    def isel(self, **indexers) -> "DataArray":
        data = self.data
        coords = dict(self.coords)
        for dim, idx in indexers.items():
            ax = self.dims.index(dim)
            data = np.take(data, idx, axis=ax) if isinstance(data, np.ndarray) else _take(data, idx, ax)
            if dim in coords:
                c = coords[dim]
                coords[dim] = c.isel(idx) if isinstance(c, TimeIndex) else np.asarray(c)[idx]
        return DataArray(data, self.dims, coords, dict(self.attrs), self.name)

    def sel(self, **indexers) -> "DataArray":
        """Label-based selection (the xarray idiom used throughout the
        reference's workflows): ``time=slice("1981", "2010")`` (inclusive,
        partial dates fill to period bounds) or exact labels / label lists
        on any coordinate.  Scalar labels drop the dimension."""
        out = self
        for dim, lab in indexers.items():
            ax = out.dims.index(dim)
            c = out.coords.get(dim)
            if isinstance(lab, slice):
                if isinstance(c, TimeIndex):
                    keys = c.year * 10000 + c.month * 100 + c.day
                    lo = _date_key(lab.start, end=False) if lab.start is not None else keys.min()
                    hi = _date_key(lab.stop, end=True) if lab.stop is not None else keys.max()
                    idx = np.flatnonzero((keys >= lo) & (keys <= hi))
                else:
                    cv = np.asarray(c)
                    lo = lab.start if lab.start is not None else cv.min()
                    hi = lab.stop if lab.stop is not None else cv.max()
                    idx = np.flatnonzero((cv >= lo) & (cv <= hi))
                out = out.isel(**{dim: idx})
            else:
                cv = np.asarray(c)
                if np.ndim(lab) == 0:
                    hits = np.flatnonzero(cv == lab)
                    if len(hits) != 1:
                        raise KeyError(f"{lab!r} not found (or not unique) in coordinate {dim!r}")
                    data = np.take(out.data, hits[0], axis=ax) if isinstance(out.data, np.ndarray) else out.data.select(ax, int(hits[0]))
                    dims = tuple(d for d in out.dims if d != dim)
                    coords = {k: v for k, v in out.coords.items() if k != dim}
                    out = DataArray(data, dims, coords, dict(out.attrs), out.name)
                else:
                    hits = [np.flatnonzero(cv == v) for v in lab]
                    missing = [v for v, h in zip(lab, hits) if len(h) == 0]
                    if missing:
                        raise KeyError(f"{missing!r} not found in coordinate {dim!r}")
                    idx = np.concatenate(hits)
                    out = out.isel(**{dim: idx})
        return out

    def expand_dims(self, dim: str, axis: int = 0, coord=None) -> "DataArray":
        data = np.expand_dims(self.data, axis) if isinstance(self.data, np.ndarray) else self.data.unsqueeze(axis)
        dims = list(self.dims)
        dims.insert(axis, dim)
        coords = dict(self.coords)
        if coord is not None:
            coords[dim] = coord
        return DataArray(data, tuple(dims), coords, dict(self.attrs), self.name)

    def astype(self, dtype) -> "DataArray":
        if isinstance(self.data, np.ndarray):
            return self.copy(data=self.data.astype(dtype))
        return self.copy(data=self.data.to(dtype))

    def reduce(self, fn, dim: str | tuple | None = None, keep_attrs: bool = False) -> "DataArray":
        """Reduce along named dimension(s) with ``fn(data, axis=...)`` —
        the xarray-style reduction surface (NaN handling is ``fn``'s)."""
        dims = (dim,) if isinstance(dim, str) else (tuple(self.dims) if dim is None else tuple(dim))
        axes = tuple(self.dims.index(d) for d in dims)
        out = fn(self.data, axis=axes if len(axes) > 1 else axes[0])
        new_dims = tuple(d for d in self.dims if d not in dims)
        coords = {d: c for d, c in self.coords.items() if d in new_dims}
        return DataArray(out, new_dims, coords, dict(self.attrs) if keep_attrs else {}, self.name)

    def _nanreduce(name):  # noqa: N805 - factory, not a method
        def _f(self, dim=None, keep_attrs=False):
            fn = getattr(np, f"nan{name}") if isinstance(self.data, np.ndarray) else nanreduce(name)
            return self.reduce(fn, dim, keep_attrs)

        _f.__name__ = name
        _f.__doc__ = f"NaN-skipping {name} over named dimension(s) (xarray-style)."
        return _f

    mean = _nanreduce("mean")
    std = _nanreduce("std")
    var = _nanreduce("var")
    sum = _nanreduce("sum")
    min = _nanreduce("min")
    max = _nanreduce("max")
    del _nanreduce

    def __array__(self, dtype=None, copy=None):
        arr = to_numpy(self.data)
        return arr.astype(dtype) if dtype is not None else arr


class Dataset:
    """Mapping of variable name -> DataArray, plus shared attrs."""

    __slots__ = ("data_vars", "attrs")

    def __init__(self, data_vars=None, attrs=None):
        self.data_vars = dict(data_vars or {})
        for k, v in self.data_vars.items():
            if isinstance(v, DataArray) and v.name is None:
                v.name = k
        self.attrs = dict(attrs or {})

    def __getitem__(self, key) -> DataArray:
        return self.data_vars[key]

    def __setitem__(self, key, value: DataArray):
        self.data_vars[key] = value

    def __contains__(self, key):
        return key in self.data_vars

    def __iter__(self):
        return iter(self.data_vars)

    def keys(self):
        return self.data_vars.keys()

    def values(self):
        return self.data_vars.values()

    def items(self):
        return self.data_vars.items()

    def __repr__(self):
        return f"<xsdba_tpu_torch.Dataset vars={list(self.data_vars)} attrs={list(self.attrs)}>"

    def copy(self) -> "Dataset":
        return Dataset({k: v.copy() for k, v in self.data_vars.items()}, dict(self.attrs))

    def sel(self, **indexers) -> "Dataset":
        """Label-based selection applied to every variable (dims absent from
        a variable are skipped for it)."""
        out = {}
        for k, v in self.data_vars.items():
            here = {d: lab for d, lab in indexers.items() if d in v.dims}
            out[k] = v.sel(**here) if here else v.copy()
        return Dataset(out, dict(self.attrs))

    def isel(self, **indexers) -> "Dataset":
        out = {}
        for k, v in self.data_vars.items():
            here = {d: idx for d, idx in indexers.items() if d in v.dims}
            out[k] = v.isel(**here) if here else v.copy()
        return Dataset(out, dict(self.attrs))


def _take(data: torch.Tensor, idx, ax: int) -> torch.Tensor:
    idx = torch.as_tensor(np.asarray(idx), device=data.device)
    if idx.ndim == 0:
        return data.select(ax, int(idx))
    return data.index_select(ax, idx.reshape(-1).long()).reshape(data.shape[:ax] + idx.shape + data.shape[ax + 1 :])


def _operands(a, b):
    """Bring two operands to one kind: tensors if either is a tensor (on its
    device), numpy otherwise; python scalars pass through."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        dev = a.device if isinstance(a, torch.Tensor) else b.device
        a = a if np.isscalar(a) or isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a), device=dev)
        b = b if np.isscalar(b) or isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b), device=dev)
        return a, b
    return (a if np.isscalar(a) else np.asarray(a)), (b if np.isscalar(b) else np.asarray(b))


def _binop(op):
    def _f(self, other):
        other_data = other.data if isinstance(other, DataArray) else other
        return self.copy(data=op(*_operands(self.data, other_data)))

    return _f


def _rbinop(op):
    def _f(self, other):
        return self.copy(data=op(*_operands(other, self.data)))

    return _f


import operator as _operator  # noqa: E402

DataArray.__add__ = _binop(_operator.add)
DataArray.__sub__ = _binop(_operator.sub)
DataArray.__mul__ = _binop(_operator.mul)
DataArray.__truediv__ = _binop(_operator.truediv)
DataArray.__pow__ = _binop(_operator.pow)
DataArray.__neg__ = lambda self: self.copy(data=-self.data)
DataArray.__radd__ = _rbinop(_operator.add)
DataArray.__rsub__ = _rbinop(_operator.sub)
DataArray.__rmul__ = _rbinop(_operator.mul)
DataArray.__rtruediv__ = _rbinop(_operator.truediv)
DataArray.__lt__ = _binop(_operator.lt)
DataArray.__le__ = _binop(_operator.le)
DataArray.__gt__ = _binop(_operator.gt)
DataArray.__ge__ = _binop(_operator.ge)


# -- xarray interop (optional dependency) ------------------------------------


def from_xarray(obj):
    """Convert an ``xarray.DataArray``/``Dataset`` into the xsdba_tpu_torch
    containers (requires xarray; times must be decodable to y/m/d)."""
    import xarray as xr  # noqa: F401  (ImportError is the contract)

    if hasattr(obj, "data_vars"):
        return Dataset({k: from_xarray(v) for k, v in obj.data_vars.items()}, dict(obj.attrs))
    coords = {}
    for name, c in obj.coords.items():
        if name == "time":
            t = obj.indexes["time"]
            cal = getattr(t, "calendar", "standard")
            coords["time"] = TimeIndex(
                np.asarray(t.year), np.asarray(t.month), np.asarray(t.day), cal
            )
        elif c.dims == (name,):
            coords[name] = np.asarray(c.values)
    return DataArray(np.asarray(obj.values), tuple(obj.dims), coords, dict(obj.attrs), obj.name)


def to_xarray(da):
    """Convert back to xarray (requires xarray + a datetime backend)."""
    import xarray as xr

    if isinstance(da, Dataset):  # Dataset has no .coords; recurse per variable
        return xr.Dataset({k: to_xarray(v) for k, v in da.items()}, attrs=da.attrs)

    coords = {}
    for name, c in da.coords.items():
        if isinstance(c, TimeIndex):
            coords[name] = xr.date_range(
                f"{c.year[0]:04d}-{c.month[0]:02d}-{c.day[0]:02d}",
                periods=len(c),
                freq=c.infer_freq() or "D",
                calendar=c.calendar,
                use_cftime=c.calendar != "standard",
            )
        elif np.ndim(c) == 1 and len(c) in da.shape:
            coords[name] = np.asarray(c)
    dims_coords = {d: coords[d] for d in da.dims if d in coords}
    return xr.DataArray(to_numpy(da.data), dims=da.dims, coords=dims_coords, attrs={k: v for k, v in da.attrs.items() if not isinstance(v, dict)}, name=da.name)
