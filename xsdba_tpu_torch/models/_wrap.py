"""Shared glue between labeled DataArrays and the tensor cores."""

from __future__ import annotations

import weakref
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.interp import bracket_steps
from ..utils.container import DataArray
from ..utils.grouper import GroupIndexes
from ..utils.profiling import span
from ..utils.tensor import as_tensor, default_device, input_tensor, upload

__all__ = [
    "Brackets",
    "batch_of",
    "clear_device_cache",
    "device_brackets",
    "fold_add_dims",
    "grouped_var",
    "scen_like",
    "to_compute",
    "to_device_cached",
    "training_tensors",
]


@dataclass
class Brackets:
    """Bracket partitions of the time axis, as index tensors on one device
    (see ``GroupIndexes.bracket_partitions``).  Unpacks like the 7-tuple
    ``(part0, g0, slot0, part1, g1, slot1, w)``; the second partition is
    None when the brackets collapse onto one group.  ``steps`` holds blended
    brackets as the bracketed lookup kernel takes them (``g0``, ``g1`` int32
    and ``w`` float32: ``ops/interp.py:bracket_steps``), so that an adjust
    converts nothing."""

    part0: torch.Tensor
    g0: torch.Tensor
    slot0: torch.Tensor
    part1: torch.Tensor | None = None
    g1: torch.Tensor | None = None
    slot1: torch.Tensor | None = None
    w: torch.Tensor | None = None
    steps: tuple | None = None

    def __iter__(self):
        return iter((self.part0, self.g0, self.slot0, self.part1, self.g1, self.slot1, self.w))


def device_brackets(gi: GroupIndexes, method: str = "linear", device=None) -> Brackets:
    """Bracket partitions on ``device`` (CPU by default).

    Collapsed brackets (nearest method, integer fractional indexes like
    dayofyear) drop the second partition entirely.  The partitions are
    built on the host at every call (span ``lower.brackets``).
    """
    with span("lower.brackets"):
        b = gi.bracket_partitions(method)
        idx = lambda a: upload(a, dtype=torch.int64, device=device)  # noqa: E731
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
            upload(b["w"], device=device),
            bracket_steps(b["g0"], b["g1"], b["w"], device),
        )


_DEV_CACHE: dict = {}
_DEV_CACHE_MAX = 32
#: uploads :func:`to_device_cached` made because no cached copy matched
misses = 0


def _fingerprint(a: np.ndarray) -> int:
    """Cheap content fingerprint (~1k sampled elements), the reference's:
    realistic in-place mutations (whole-array or blockwise updates) change
    it and so invalidate the buffer-identity cache; a surgical
    single-element edit between the sample points can still escape, so
    callers must not mutate inputs in place."""
    flat = np.ravel(a)
    if flat.size == 0:
        return 0
    step = max(1, flat.size // 1024)
    sample = np.concatenate([flat[::step][:1025], flat[-8:]])
    return zlib.crc32(sample.tobytes())


def to_device_cached(a, device=None) -> torch.Tensor:
    """Copy of a host array on ``device`` (the ``device`` option's by
    default), cached by buffer identity, fingerprint and device.

    Public calls on the same numpy-backed DataArrays (train then adjust,
    parameter sweeps) would otherwise upload identical inputs on every
    call.  The key is the reference's (the owning buffer's id, the data
    pointer, shape, strides, dtype and :func:`_fingerprint`, so views hit
    too and in-place mutation between calls misses) plus the device, since
    the ``device`` option may change between calls.  An entry dies with its
    owning buffer (``weakref.finalize``), the oldest goes past
    ``_DEV_CACHE_MAX`` entries, and an owner that takes no weak reference
    (a ``bytes`` or ``mmap`` base) is not cached.  The copy is the cache's
    own on every device, the CPU too, never a view of the caller's buffer;
    the same tensor is handed to every call that hits, so no caller may
    write into it.  A tensor is not cached: it keeps its device unless
    ``device`` is given, and then goes there.  Other data is converted
    uncached."""
    global misses
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    dev = torch.device(device) if device is not None else default_device()
    if not isinstance(a, np.ndarray):
        return as_tensor(a, device=dev)
    owner = a.base if a.base is not None else a
    key = (id(owner), a.__array_interface__["data"][0], a.shape, a.strides, a.dtype.str, _fingerprint(a), str(dev))
    hit = _DEV_CACHE.get(key)
    if hit is not None:
        return hit
    misses += 1
    out = upload(a, device=dev, copy=True)  # a copy, also on the CPU
    try:
        weakref.finalize(owner, _DEV_CACHE.pop, key, None)
    except TypeError:
        # owner not weakref-able: the entry could never be invalidated and
        # its (id, ptr, ...) key is recyclable after GC, so it is not cached
        return out
    while len(_DEV_CACHE) >= _DEV_CACHE_MAX:
        _DEV_CACHE.pop(next(iter(_DEV_CACHE)))
    _DEV_CACHE[key] = out
    return out


def clear_device_cache() -> None:
    """Drop every cached device copy (:func:`to_device_cached`)."""
    _DEV_CACHE.clear()


def to_compute(da: DataArray):
    """DataArray -> (tensor [..., T], batch dims, batch coords).  A tensor
    keeps its device; numpy data goes to the ``device`` option's device
    through the device-copy cache (:func:`to_device_cached`)."""
    da = da.move_dim_last("time")
    batch_dims = da.dims[:-1]
    batch_coords = {d: da.coords[d] for d in batch_dims if d in da.coords}
    return to_device_cached(da.data), batch_dims, batch_coords


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
        arr = input_tensor(dac.data)
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


def training_tensors(group, ref: DataArray, hist: DataArray):
    """What a grouped training starts from: ``(refa, hista, batch dims,
    batch coords, gi, gi_t)`` with ref and hist as [..., T] tensors on one
    device (``group.add_dims`` folded into the time axis for pooled
    training), ``gi`` the group indexes of ref's time axis and ``gi_t``
    those of the tensors' (expanded over the folded dims)."""
    gi = group.indexes(ref.time)
    if group.add_dims:
        # pooled training over the extra dims (reference base.py:413)
        (refa, hista), bdims, bcoords, n_add = fold_add_dims(group, ref, hist)
        gi_t = gi.expand(n_add)
    else:
        refa, bdims, bcoords = to_compute(ref)
        hista, _, _ = to_compute(hist)
        gi_t = gi
    return refa, hista.to(refa.device), bdims, bcoords, gi, gi_t


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
    with span("api.output"):
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
    with span("api.output"):
        simc = sim.move_dim_last("time")
        out = DataArray(values, simc.dims, dict(simc.coords), dict(sim.attrs), name)
        if simc.dims != sim.dims:
            out = out.transpose(*sim.dims)
        return out
