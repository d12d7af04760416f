"""Statistical measures: difference metrics between a simulated property and
its reference counterpart (reference ``measures.py``).  They compute on the
inputs' device and return a DataArray there."""

from __future__ import annotations

import numpy as np
import torch

from .utils.container import DataArray
from .utils.grouper import Grouper
from .utils.tensor import input_tensor, nanstd
from .utils.units import convert_units_to, harmonize_units

__all__ = [
    "StatisticalMeasure",
    "StatisticalPropertyMeasure",
    "annual_cycle_correlation",
    "bias",
    "circular_bias",
    "mae",
    "ratio",
    "relative_bias",
    "rmse",
    "scorr",
    "taylordiagram",
]


class StatisticalMeasure:
    """Base class for measures comparing ``sim`` against ``ref`` (reference
    ``measures.py:26-62``): both inputs must be DataArrays with identical
    coordinates on their common dimensions; ``sim`` is converted to
    ``ref``'s units, then the compute function runs.
    """

    realm = "generic"

    def __init__(self, identifier: str, compute, units: str | None = None):
        self.identifier = identifier
        self._compute = compute
        self._units = units
        self.__doc__ = compute.__doc__

    def _preprocess_and_checks(self, sim: DataArray, ref: DataArray):
        if not isinstance(sim, DataArray) or not isinstance(ref, DataArray):
            raise TypeError(f"{self.identifier} requires DataArray 'sim' and 'ref' inputs.")
        if sim.attrs.get("units", "") != ref.attrs.get("units", ""):
            sim = convert_units_to(sim, ref)
        for dim in set(sim.dims) & set(ref.dims):
            cs, cr = sim.coords.get(dim), ref.coords.get(dim)
            if sim.sizes[dim] != ref.sizes[dim] or (
                cs is not None and cr is not None and not np.array_equal(np.asarray(cs), np.asarray(cr))
            ):
                raise ValueError(f"Common dimension {dim} has different coordinates between ref and sim.")
        return sim, ref

    def __call__(self, sim: DataArray, ref: DataArray, *args, **kwargs) -> DataArray:
        sim, ref = self._preprocess_and_checks(sim, ref)
        out = self._compute(sim, ref, *args, **kwargs)
        if self._units is not None:
            out.attrs["units"] = self._units
        out.attrs.setdefault("long_name", self.identifier)
        return out


class StatisticalPropertyMeasure(StatisticalMeasure):
    """A property and measure in one (reference ``measures.py:65-131``): adds
    the ``aspect`` attribute and the ``allowed_groups`` check of a ``group``
    keyword to the :class:`StatisticalMeasure` checks."""

    def __init__(self, identifier: str, compute, aspect: str, allowed_groups=None, units: str | None = None):
        super().__init__(identifier, compute, units)
        self.aspect = aspect
        self.allowed_groups = allowed_groups

    def __call__(self, sim: DataArray, ref: DataArray, *args, **kwargs) -> DataArray:
        group = kwargs.pop("group", "time")
        group = Grouper(group) if isinstance(group, str) else group
        if self.allowed_groups is not None and group.prop not in self.allowed_groups:
            raise ValueError(
                f"Grouping period {group.prop_name} is not allowed for property "
                f"{self.identifier} (needs one of {self.allowed_groups})."
            )
        out = super().__call__(sim, ref, *args, **kwargs)
        out.attrs["aspect"] = self.aspect
        return out


def _pair(sim: DataArray, ref: DataArray):
    (sim, ref), _ = harmonize_units(sim, ref)
    s = input_tensor(sim.data)
    return s, input_tensor(ref.data).to(s.device), sim


def _wrap(sim: DataArray, vals, name, units):
    return DataArray(vals, sim.dims, dict(sim.coords), {"units": units, "long_name": name}, name)


def _bias(sim: DataArray, ref: DataArray) -> DataArray:
    """sim - ref (reference measures.py:138-160)."""
    s, r, sim = _pair(sim, ref)
    return _wrap(sim, s - r, "bias", sim.units)


def _relative_bias(sim: DataArray, ref: DataArray) -> DataArray:
    """(sim - ref) / ref (reference measures.py:163-186)."""
    s, r, sim = _pair(sim, ref)
    return _wrap(sim, (s - r) / r, "relative_bias", "")


def _circular_bias(sim: DataArray, ref: DataArray) -> DataArray:
    """Day-of-year bias on the circle (reference measures.py:189-215): the
    magnitude is the least circular distance mod 365, the sign that of the
    linear comparison ``ref >= sim``, as the reference has it."""
    s, r, sim = _pair(sim, ref)
    d = torch.remainder(s - r, 365)
    mag = torch.where(d > 365 / 2, 365 - d, d)
    return _wrap(sim, torch.where(r >= s, mag, -mag), "circular_bias", "d")


def _ratio(sim: DataArray, ref: DataArray) -> DataArray:
    """sim / ref (reference measures.py:218-240)."""
    s, r, sim = _pair(sim, ref)
    return _wrap(sim, s / r, "ratio", "")


def _along(sim: DataArray, ref: DataArray, dim: str):
    """(sim, ref) as tensors with ``dim`` last, batch dims, batch coords."""
    (sim, ref), _ = harmonize_units(sim, ref)
    sc, rc = sim.move_dim_last(dim), ref.move_dim_last(dim)
    s = input_tensor(sc.data)
    bdims = sc.dims[:-1]
    return s, input_tensor(rc.data).to(s.device), bdims, {d: sc.coords[d] for d in bdims if d in sc.coords}, sim.units


def _rmse(sim: DataArray, ref: DataArray, dim: str = "time") -> DataArray:
    """Root mean square error along ``dim`` (reference measures.py:243-287)."""
    s, r, bdims, bcoords, units = _along(sim, ref, dim)
    return DataArray(torch.sqrt(torch.nanmean((s - r) ** 2, dim=-1)), bdims, bcoords, {"units": units, "long_name": "rmse"}, "rmse")


def _mae(sim: DataArray, ref: DataArray, dim: str = "time") -> DataArray:
    """Mean absolute error along ``dim`` (reference measures.py:290-332)."""
    s, r, bdims, bcoords, units = _along(sim, ref, dim)
    return DataArray(torch.nanmean((s - r).abs(), dim=-1), bdims, bcoords, {"units": units, "long_name": "mae"}, "mae")


def _nan_pearson(a, b):
    """Pearson correlation along the last axis over the pairs where both
    are valid."""
    m = ~torch.isnan(a) & ~torch.isnan(b)
    n = torch.clamp(m.sum(dim=-1, keepdim=True), min=1)
    ma = torch.where(m, a, 0.0).sum(dim=-1, keepdim=True) / n
    mb = torch.where(m, b, 0.0).sum(dim=-1, keepdim=True) / n
    ac, bc = torch.where(m, a - ma, 0.0), torch.where(m, b - mb, 0.0)
    return (ac * bc).sum(dim=-1) / torch.sqrt((ac * ac).sum(dim=-1) * (bc * bc).sum(dim=-1))


def _annual_cycle_correlation(sim: DataArray, ref: DataArray, window: int = 15) -> DataArray:
    """Pearson correlation of the smoothed day-of-year climatologies
    (reference measures.py:335-380)."""
    from .properties import _doy_climatology

    (sim, ref), _ = harmonize_units(sim, ref)
    clim_s, bdims, bcoords = _doy_climatology(sim, window)
    clim_r, _, _ = _doy_climatology(ref, window)
    out = _nan_pearson(clim_s, clim_r.to(clim_s.device))
    return DataArray(out, bdims, bcoords, {"units": "", "long_name": "annual_cycle_correlation"}, "annual_cycle_correlation")


def _scorr(sim: DataArray, ref: DataArray, dims=None) -> DataArray:
    """The ratio of the summed inter-site Spearman correlation matrices of
    sim and ref (reference measures.py:383-422)."""
    from .properties import _pairwise_spearman

    sc, rc = sim.move_dim_last("time"), ref.move_dim_last("time")
    s = input_tensor(sc.data)
    r = input_tensor(rc.data).to(s.device)
    corr_s = torch.nansum(_pairwise_spearman(s.reshape(-1, s.shape[-1])))
    corr_r = torch.nansum(_pairwise_spearman(r.reshape(-1, r.shape[-1])))
    return DataArray(corr_s / corr_r, (), {}, {"units": "", "long_name": "scorr"}, "scorr")


def _taylordiagram(sim: DataArray, ref: DataArray, dim: str = "time", normalize: bool = False) -> DataArray:
    """Taylor-diagram triplet (ref std, sim std, correlation) along ``dim``
    (reference measures.py:425-494)."""
    s, r, bdims, bcoords, units = _along(sim, ref, dim)
    sim_std, ref_std = nanstd(s, axis=-1), nanstd(r, axis=-1)
    corr = _nan_pearson(s, r)
    if normalize:
        sim_std = sim_std / ref_std
        ref_std = torch.ones_like(ref_std)
    coords = {"taylor_param": np.array(["ref_std", "sim_std", "corr"]), **bcoords}
    attrs = {"units": "" if normalize else units, "long_name": "taylordiagram"}
    return DataArray(torch.stack([ref_std, sim_std, corr], dim=0), ("taylor_param",) + bdims, coords, attrs, "taylordiagram")


# -- public instances (reference measures.py:161-494) --------------------------

bias = StatisticalMeasure("bias", _bias)
relative_bias = StatisticalMeasure("relative_bias", _relative_bias, units="")
circular_bias = StatisticalMeasure("circular_bias", _circular_bias, units="days")
ratio = StatisticalMeasure("ratio", _ratio, units="")
rmse = StatisticalPropertyMeasure("rmse", _rmse, aspect="temporal", allowed_groups=["group"])
mae = StatisticalPropertyMeasure("mae", _mae, aspect="temporal", allowed_groups=["group"])
annual_cycle_correlation = StatisticalPropertyMeasure(
    "annual_cycle_correlation", _annual_cycle_correlation, aspect="temporal", allowed_groups=["group"], units=""
)
scorr = StatisticalPropertyMeasure("Scorr", _scorr, aspect="spatial", allowed_groups=["group"], units="")
taylordiagram = StatisticalPropertyMeasure("taylordiagram", _taylordiagram, aspect="temporal", allowed_groups=["group"])
