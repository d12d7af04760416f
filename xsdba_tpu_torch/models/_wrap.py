"""Shared glue between labeled DataArrays and the tensor cores."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.container import DataArray
from ..utils.grouper import GroupIndexes
from ..utils.tensor import as_tensor

__all__ = ["Brackets", "batch_of", "device_brackets", "fold_add_dims", "grouped_var", "scen_like", "to_compute"]


@dataclass
class Brackets:
    """Bracket partitions of the time axis, as index tensors on one device
    (see ``GroupIndexes.bracket_partitions``).  Unpacks like the 7-tuple
    ``(part0, g0, slot0, part1, g1, slot1, w)``; the second partition is
    None when the brackets collapse onto one group."""

    part0: torch.Tensor
    g0: torch.Tensor
    slot0: torch.Tensor
    part1: torch.Tensor | None = None
    g1: torch.Tensor | None = None
    slot1: torch.Tensor | None = None
    w: torch.Tensor | None = None

    def __iter__(self):
        return iter((self.part0, self.g0, self.slot0, self.part1, self.g1, self.slot1, self.w))


def device_brackets(gi: GroupIndexes, method: str = "linear", device=None) -> Brackets:
    """Bracket partitions on ``device`` (CPU by default).

    Collapsed brackets (nearest method, integer fractional indexes like
    dayofyear) drop the second partition entirely.
    """
    b = gi.bracket_partitions(method)
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)  # noqa: E731
    # collapsed brackets, or integer fractional indexes (dayofyear): the g1
    # side always has zero weight, so skip its partition entirely
    if bool((b["g0"] == b["g1"]).all()) or bool((b["w"] == 0).all()):
        return Brackets(idx(b["part0"]), idx(b["g0"]), idx(b["slot0"]))
    return Brackets(
        idx(b["part0"]),
        idx(b["g0"]),
        idx(b["slot0"]),
        idx(b["part1"]),
        idx(b["g1"]),
        idx(b["slot1"]),
        torch.as_tensor(b["w"], device=device),
    )


def to_compute(da: DataArray):
    """DataArray -> (tensor [..., T] on the data's device, batch dims,
    batch coords).  Numpy data becomes a CPU tensor."""
    da = da.move_dim_last("time")
    batch_dims = da.dims[:-1]
    batch_coords = {d: da.coords[d] for d in batch_dims if d in da.coords}
    return as_tensor(da.data), batch_dims, batch_coords


def fold_add_dims(group, *das: DataArray):
    """Fold ``group.add_dims`` batch dims into the time axis for pooled
    training (reference ``base.py:413``: the grouped reduction runs over
    ``[dim] + add_dims + window``).

    Arrays missing one of the add_dims are first broadcast over it, matching
    the implicit xarray ``Dataset`` broadcast in the reference's
    ``Grouper.group``.  Returns ``(tensors [..., A*T], batch_dims,
    batch_coords, n_add)`` — pair with ``GroupIndexes.expand(n_add)``.
    """
    adims = list(group.add_dims)
    sizes: dict[str, int] = {}
    for da in das:
        for d, s in zip(da.dims, da.shape):
            if d in adims:
                sizes[d] = s
    if any(d not in sizes for d in adims):
        raise ValueError("`add_dims` argument needs to be a dimension in one of the input datasets.")
    n_add = int(np.prod([sizes[d] for d in adims], dtype=np.int64))

    outs = []
    bdims: tuple = ()
    bcoords: dict = {}
    for i, da in enumerate(das):
        dac = da.move_dim_last("time")
        arr = as_tensor(dac.data)
        dims = list(dac.dims)
        for d in adims:
            if d not in dims:
                arr = arr[..., None, :].expand(arr.shape[:-1] + (sizes[d], arr.shape[-1]))
                dims.insert(len(dims) - 1, d)
        perm = (
            [j for j, d in enumerate(dims) if d not in adims and d != "time"]
            + [dims.index(d) for d in adims]
            + [dims.index("time")]
        )
        arr = arr.permute(perm)
        batch = arr.shape[: arr.ndim - 1 - len(adims)]
        outs.append(arr.reshape(batch + (n_add * arr.shape[-1],)))
        if i == 0:
            bdims = tuple(dims[j] for j in perm if dims[j] not in adims and dims[j] != "time")
            bcoords = {d: dac.coords[d] for d in bdims if d in dac.coords}
    return outs, bdims, bcoords, n_add


def batch_of(da: DataArray):
    return tuple(s for d, s in zip(da.dims, da.shape) if d != "time")


def grouped_var(
    values,
    batch_dims,
    batch_coords,
    gi: GroupIndexes,
    extra_dim: tuple[str, np.ndarray] | None = None,
    attrs=None,
    name=None,
) -> DataArray:
    """Wrap a [..., G(, nq)] core output into a labeled DataArray."""
    prop = "group" if gi.prop == "group" else gi.prop
    dims = tuple(batch_dims) + (prop,)
    coords = dict(batch_coords)
    coords[prop] = gi.coord
    if extra_dim is not None:
        dims = dims + (extra_dim[0],)
        coords[extra_dim[0]] = extra_dim[1]
    return DataArray(values, dims, coords, attrs or {}, name)


def scen_like(sim: DataArray, values, name: str = "scen") -> DataArray:
    """Wrap adjusted values (time-last layout) back into sim's dim order."""
    simc = sim.move_dim_last("time")
    out = DataArray(values, simc.dims, dict(simc.coords), dict(sim.attrs), name)
    if simc.dims != sim.dims:
        out = out.transpose(*sim.dims)
    return out
