"""Detrending objects (reference ``detrending.py``).

Port of ``xsdba_tpu/detrending.py``: the fit / detrend / retrend scheme
over the trend cores of ``ops/detrend.py`` (polynomial, by masked normal
equations) and ``ops/loess.py`` (LOESS), a rolling mean, the group mean and
none.  A fitted object holds its trend in ``ds["trend"]`` and saves and
loads like an adjustment object, across the two packages.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .ops.correction import ADDITIVE, apply_correction, invert
from .ops.segment import gather_groups, scatter_back
from .utils.container import DataArray, Dataset
from .utils.grouper import Grouper
from .utils.params import ParametrizableWithDataset
from .utils.tensor import as_tensor, input_tensor

__all__ = [
    "BaseDetrend",
    "LoessDetrend",
    "MeanDetrend",
    "NoDetrend",
    "PolyDetrend",
    "RollingMeanDetrend",
]


def _series(da: DataArray) -> torch.Tensor:
    """``da``'s values, time last, as a tensor (numpy data on the ``device``
    option's device)."""
    return input_tensor(da.move_dim_last("time").data)


def _like(da: DataArray, values, name) -> DataArray:
    """``values`` (time last) as a DataArray in ``da``'s dim order."""
    from .models._wrap import scen_like  # models imports this module

    return scen_like(da, values, name=name)


class BaseDetrend(ParametrizableWithDataset):
    """fit(da) -> a fitted object; detrend(da); retrend(da)
    (reference detrending.py:17-131)."""

    def __init__(self, *, group: str | Grouper = "time", kind: str = ADDITIVE, mult_skip_zeros: bool = False, **kwargs):
        group = Grouper(group) if isinstance(group, str) else group
        super().__init__(group=group, kind=kind, mult_skip_zeros=mult_skip_zeros, **kwargs)

    @property
    def fitted(self) -> bool:
        return hasattr(self, "ds")

    def fit(self, da: DataArray) -> "BaseDetrend":
        new = self.__class__(**self.parameters)
        trend = new._get_trend(da)
        trend.name = "trend"
        if "units" in da.attrs:
            trend.attrs["units"] = da.attrs["units"]
        new.set_dataset(Dataset({"trend": trend}))
        return new

    def _trend_of(self, x: torch.Tensor) -> torch.Tensor:
        return as_tensor(self.ds["trend"].move_dim_last("time").data, device=x.device)

    def detrend(self, da: DataArray) -> DataArray:
        if not self.fitted:
            raise ValueError("You must call fit() before detrending.")
        x = _series(da)
        trend = self._trend_of(x)
        out = apply_correction(x, invert(trend, self.kind), self.kind)
        if self.mult_skip_zeros and self.kind != "*":
            warnings.warn("mult_skip_zeros is only used for kind='*'; ignored.", UserWarning, stacklevel=2)
        if self.mult_skip_zeros and self.kind == "*":
            out = torch.where(trend != 0, out, x)
        return _like(da, out, da.name)

    def retrend(self, da: DataArray) -> DataArray:
        if not self.fitted:
            raise ValueError("You must call fit() before retrending.")
        x = _series(da)
        return _like(da, apply_correction(x, self._trend_of(x), self.kind), da.name)

    # subclasses implement
    def _get_trend(self, da: DataArray) -> DataArray:
        raise NotImplementedError

    def __repr__(self):
        rep = super().__repr__()
        return rep if self.fitted else f"<{rep} | unfitted>"


class NoDetrend(BaseDetrend):
    """Does nothing (reference detrending.py:134-147)."""

    def _get_trend(self, da):
        return da.copy(data=torch.zeros_like(input_tensor(da.data)))

    def detrend(self, da):
        self._require_fit()
        return da

    def retrend(self, da):
        self._require_fit()
        return da

    def _require_fit(self):
        if not self.fitted:
            raise ValueError("You must call fit() first.")


class MeanDetrend(BaseDetrend):
    """Group-mean trend (reference detrending.py:150-162)."""

    def _get_trend(self, da):
        gi = self.group.indexes(da.time)
        means = torch.nanmean(gather_groups(_series(da), gi.gather_idx), dim=-1)
        return _like(da, means[..., torch.as_tensor(gi.group_idx, device=means.device).long()], "trend")


class PolyDetrend(BaseDetrend):
    """Polynomial trend a group (reference detrending.py:165-208), degree 4
    by default; ``preserve_mean`` keeps each group's mean in the detrended
    series."""

    def __init__(self, group="time", kind=ADDITIVE, degree=4, preserve_mean=False, mult_skip_zeros=False):
        super().__init__(group=group, kind=kind, degree=degree, preserve_mean=preserve_mean, mult_skip_zeros=mult_skip_zeros)

    def _get_trend(self, da):
        from .ops.detrend import grouped_polyfit_trend

        gi = self.group.indexes(da.time)
        x = _series(da)
        tcoord = np.asarray(da.time.ordinal, dtype=np.float64)
        trend = grouped_polyfit_trend(x, tcoord, gi.gather_idx, gi.group_idx, gi.scatter_slot, degree=int(self.degree))
        if self.preserve_mean:
            gmean = torch.nanmean(gather_groups(trend, gi.gather_idx), dim=-1)
            trend = apply_correction(trend, invert(gmean[..., torch.as_tensor(gi.group_idx, device=x.device).long()], self.kind), self.kind)
        return _like(da, trend, "trend")


class LoessDetrend(BaseDetrend):
    """LOESS trend (reference detrending.py:211-296): local regression with
    tricube or gaussian weights and robustness iterations."""

    def __init__(self, group="time", kind=ADDITIVE, f=0.2, niter=1, d=0, weights="tricube", equal_spacing=None, skipna=True, mult_skip_zeros=False):
        # accepted for the reference's signature, but the samples are always
        # taken as equally spaced and NaNs always get zero weight (the JAX
        # package's two documented LOESS deviations)
        if equal_spacing is False:
            warnings.warn(
                "LoessDetrend: equal_spacing=False is not supported; samples are treated as equally spaced.",
                UserWarning, stacklevel=2,
            )
        if skipna is False:
            warnings.warn("LoessDetrend: skipna=False is not supported; NaNs are always zero-weighted.", UserWarning, stacklevel=2)
        super().__init__(group=group, kind=kind, f=f, niter=niter, d=d, weights=weights, equal_spacing=equal_spacing, skipna=skipna, mult_skip_zeros=mult_skip_zeros)

    def _get_trend(self, da):
        from .ops.loess import loess_smoothing

        gi = self.group.indexes(da.time)
        x = _series(da)
        kw = dict(f=self.f, niter=int(self.niter), d=int(self.d), weights=self.weights)
        if gi.n_groups == 1:
            trend = loess_smoothing(x, np.asarray(da.time.ordinal, dtype=np.float64), **kw)
        else:
            # a group's members as its series, their rank as the coordinate:
            # exact for group="time", an approximation for seasonal groups
            # (the JAX package's documented deviation)
            xg = gather_groups(x, gi.gather_idx)
            trend = scatter_back(loess_smoothing(xg, np.arange(xg.shape[-1], dtype=np.float64), **kw), gi.group_idx, gi.scatter_slot)
        return _like(da, trend, "trend")


class RollingMeanDetrend(BaseDetrend):
    """Centred rolling-mean trend, optionally weighted (reference
    detrending.py:299-356)."""

    def __init__(self, group="time", kind=ADDITIVE, win=30, weights=None, min_periods=None, mult_skip_zeros=False):
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float64)
            weights = weights / weights.sum()
            if min_periods is not None:
                raise NotImplementedError("Setting both `min_periods` and `weights` is not implemented yet.")
        super().__init__(group=group, kind=kind, win=int(win), weights=weights, min_periods=min_periods, mult_skip_zeros=mult_skip_zeros)

    def _roll(self, series):
        n = series.shape[-1]
        win = self.win
        idx = torch.arange(n, device=series.device)[:, None] + torch.arange(win, device=series.device)[None, :] - win // 2
        vals = torch.where((idx >= 0) & (idx < n), series[..., torch.clamp(idx, 0, n - 1)], torch.nan)
        if self.weights is not None:
            return (vals * torch.as_tensor(self.weights, dtype=series.dtype, device=series.device)).sum(dim=-1)
        nan = torch.isnan(vals)
        cnt = (~nan).sum(dim=-1)
        minp = self.min_periods if self.min_periods is not None else win
        mean = torch.where(nan, 0, vals).sum(dim=-1) / torch.where(cnt == 0, 1, cnt)
        return torch.where(cnt >= minp, mean, torch.nan)

    def _get_trend(self, da):
        gi = self.group.indexes(da.time)
        x = _series(da)
        if gi.n_groups == 1:
            trend = self._roll(x)
        else:
            trend = scatter_back(self._roll(gather_groups(x, gi.gather_idx)), gi.group_idx, gi.scatter_slot)
        return _like(da, trend, "trend")
