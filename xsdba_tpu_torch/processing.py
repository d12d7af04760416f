"""Pre/post-processing operations of the multivariate workflow.

Port of the part of reference ``processing.py`` + ``_processing.py`` that
the multivariate schemes and their users need: standardization, rank
reordering (the Schaake shuffle), stacking variables into one array and
back, and the energy score.  Jitter, frequency adaptation, normalization,
period stacking and the rest are not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.escore import escore as _escore_core
from .ops.segment import gather_groups
from .utils.container import DataArray, Dataset
from .utils.formatting import update_history
from .utils.grouper import Grouper
from .utils.tensor import as_tensor, input_tensor, nanstd

__all__ = [
    "escore",
    "reordering",
    "stack_variables",
    "standardize",
    "unstack_variables",
    "unstandardize",
]


def _scen_like(da: DataArray, values, name):
    from .models._wrap import scen_like

    out = scen_like(da, values, name=name)
    out.attrs.update(da.attrs)
    return out


def standardize(da: DataArray, mean=None, std=None, dim: str = "time"):
    """(x - mean)/std along dim; returns (standardized, mean, std)
    (reference processing.py:323-350)."""
    x = input_tensor(da.move_dim_last(dim).data)
    mu = torch.nanmean(x, dim=-1, keepdim=True) if mean is None else as_tensor(mean, device=x.device)
    sig = nanstd(x, axis=-1, keepdims=True) if std is None else as_tensor(std, device=x.device)
    return _scen_like(da, (x - mu) / sig, da.name), mu, sig


def unstandardize(da: DataArray, mean, std, dim: str = "time"):
    """The inverse of :func:`standardize`: ``x * std + mean`` along dim."""
    x = input_tensor(da.move_dim_last(dim).data)
    return _scen_like(da, x * as_tensor(std, device=x.device) + as_tensor(mean, device=x.device), da.name)


# ---------------------------------------------------------------------------
# reordering — reference processing.py:361-390, _processing.py:184-247
# ---------------------------------------------------------------------------


def _reordering_core(ref, sim):
    """sort(sim)[rank of ref] along the last axis: sim's values in ref's
    rank order.

    The rank of each position is the inverse of ref's stable argsort, which
    a scatter of ``arange`` along that permutation gives in one pass (the
    same integers as ``argsort(argsort(ref))``, without the second sort).
    NaNs sort last, ties keep their order, and -0.0 ties with +0.0
    (``torch.sort`` compares by value)."""
    sim_sorted = torch.sort(sim, dim=-1).values
    perm = torch.argsort(ref, dim=-1, stable=True)
    pos = torch.arange(ref.shape[-1], device=ref.device).expand(perm.shape)
    order = torch.empty_like(perm).scatter_(-1, perm, pos)
    return torch.gather(sim_sorted, -1, order)


def reordering(ref: DataArray, sim: DataArray, group: str | Grouper = "time") -> DataArray:
    """Reorder sim so its rank structure matches ref's (Schaake shuffle;
    reference processing.py:361-390), optionally within each group block."""
    group = Grouper(group) if isinstance(group, str) else group
    sv = input_tensor(sim.move_dim_last("time").data)
    rv = as_tensor(input_tensor(ref.move_dim_last("time").data), device=sv.device)
    if group.prop == "group":
        out = _reordering_core(rv, sv)
    else:
        # reorder within each group's (optionally window-expanded) members:
        # gather into [..., G, Lw] (NaN padded — pads rank last on both
        # sides, and padding both ref and sim identically leaves the ranks of
        # real elements untouched), reorder flat per group, then each
        # timestep reads its own (group, center-slot) cell.  For window > 1
        # that cell is the middle-of-window column — exactly the reference's
        # ``_reordering_2d`` (``_processing.py:205-210``: flat reorder over
        # [time, window], keep ``[:, window // 2]``).
        gi = group.indexes(sim.time)
        og = _reordering_core(gather_groups(rv, gi.gather_idx), gather_groups(sv, gi.gather_idx))   # [..., G, Lw]
        Lw = og.shape[-1]
        flat = og.reshape(og.shape[:-2] + (og.shape[-2] * Lw,))
        pos = torch.as_tensor(gi.group_idx.astype(np.int64) * Lw + gi.scatter_slot, device=sv.device)
        out = flat[..., pos]
    res = _scen_like(sim, out, sim.name)
    res.attrs["history"] = update_history("reordering(ref, sim)", sim)
    return res


# ---------------------------------------------------------------------------
# stack_variables / unstack_variables — reference processing.py:736-826
# ---------------------------------------------------------------------------


def stack_variables(ds: Dataset, rechunk: bool = True, dim: str = "multivar") -> DataArray:
    """Stack Dataset variables into one DataArray along a leading ``dim``
    (alphabetical order).  Per-variable attrs are preserved for
    :func:`unstack_variables`; units are blanked on the stacked array.
    Numpy variables stack into a numpy array (which the adjustments then
    compute on the ``device`` option's device), tensors into a tensor on
    their device.  ``rechunk`` is accepted for reference signature parity
    (processing.py:736) and ignored — there is no dask layer here."""
    items = sorted(ds.items(), key=lambda e: e[0])
    names = [nm for nm, _ in items]
    first = items[0][1]
    if any(isinstance(v.data, torch.Tensor) for _, v in items):
        dev = next(v.data.device for _, v in items if isinstance(v.data, torch.Tensor))
        data = torch.stack([as_tensor(v.data, device=dev) for _, v in items], dim=0)
    else:
        data = np.stack([np.asarray(v.data) for _, v in items], axis=0)
    coords = dict(first.coords)
    coords[dim] = np.array(names)
    attrs = dict(ds.attrs)
    attrs["units"] = ""
    attrs["_variable_attrs"] = {nm: dict(v.attrs) for nm, v in items}
    return DataArray(data, (dim,) + first.dims, coords, attrs, "multivariate")


def unstack_variables(da: DataArray, dim: str | None = None) -> Dataset:
    """Inverse of :func:`stack_variables`."""
    dim = dim or next((d for d in da.dims if d in da.coords and np.asarray(da.coords[d]).dtype.kind in "US"), None)
    if dim is None:
        raise ValueError("No variable coordinate found, were attributes removed?")
    names = [str(n) for n in np.asarray(da.coords[dim])]
    ax = da.dims.index(dim)
    var_attrs = da.attrs.get("_variable_attrs", {})
    sub_dims = tuple(d for d in da.dims if d != dim)
    coords = {k: v for k, v in da.coords.items() if k != dim}
    out = {}
    for i, nm in enumerate(names):
        data = da.data.select(ax, i) if isinstance(da.data, torch.Tensor) else np.take(da.data, i, axis=ax)
        out[nm] = DataArray(data, sub_dims, dict(coords), dict(var_attrs.get(nm, {})), nm)
    ds_attrs = {k: v for k, v in da.attrs.items() if k not in ("units", "_variable_attrs")}
    return Dataset(out, ds_attrs)


def escore(tgt: DataArray, sim: DataArray, dims=("multivar", "time"), N: int = 0, scale: bool = False) -> DataArray:
    """Energy score between two multivariate arrays (reference
    processing.py:393-489): optional even subsampling of N points and
    standardization by tgt's mean/std."""
    tgtc = tgt.move_dim_last(dims[1])
    simc = sim.move_dim_last(dims[1])
    tv = input_tensor(tgtc.data)
    sv = as_tensor(input_tensor(simc.data), device=tv.device)
    # move the multivar dim to -2
    tv = torch.movedim(tv, tgtc.dims.index(dims[0]), -2)
    sv = torch.movedim(sv, simc.dims.index(dims[0]), -2)
    if N > 0:
        tv = tv[..., :: max(1, int(np.ceil(tv.shape[-1] / N)))]
        sv = sv[..., :: max(1, int(np.ceil(sv.shape[-1] / N)))]
    if scale:
        mu = torch.nanmean(tv, dim=-1, keepdim=True)
        sd = nanstd(tv, axis=-1, keepdims=True, ddof=1)
        tv = (tv - mu) / sd
        sv = (sv - mu) / sd
    out = _escore_core(tv, sv)
    bdims = tuple(d for d in tgtc.dims if d not in dims)
    res = DataArray(out, bdims, {d: tgt.coords[d] for d in bdims if d in tgt.coords}, {}, "escores")
    res.attrs["long_name"] = "Energy dissimilarity metric"
    res.attrs["description"] = "Escores computed from paired standardized observations."
    return res
