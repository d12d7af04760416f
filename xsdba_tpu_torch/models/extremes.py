"""Second-order extreme-value adjustment (reference ``adjustment.py:745-930``,
``_adjustment.py:1060-1233``).

Cluster extraction and the GPD ML fit run batched on the data's device
(``ops/clusters.py``, ``ops/fitting.py``); the adjust blends the
tail-corrected scenario into a first-order scenario with the smooth
transition function.  The JAX package NaN-pads the time axis to a multiple
of 4096 so that nearby lengths share one compilation; NaNs are inert in
every step, so the port computes on the series as they are.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from ..ops.clusters import cluster_maxima
from ..ops.cuda.fma_kernel import fma
from ..ops.fitting import gpd_cdf, gpd_fit_ml, gpd_ppf
from ..ops.interp import interp1d_table
from ..ops.quantile import nan_quantile
from ..utils.container import DataArray, Dataset
from ..utils.tensor import _check_leading, as_tensor, nanmax, nanmin
from ..utils.units import convert_units_to
from ._wrap import scen_like, to_compute
from .base import TrainAdjust

__all__ = ["ExtremeValues"]


def _fit(x, thresh, cluster_thresh, max_clusters: int):
    """GPD fit (shape, scale) of the cluster maxima's excesses over ``thresh``."""
    mx = cluster_maxima(x, thresh[..., None], cluster_thresh, max_clusters=max_clusters)
    return gpd_fit_ml(mx - thresh[..., None])


def _extremes_train_core(ref, hist, cluster_thresh, q_thresh: float, ref_params=None, *, n_out: int, max_clusters: int):
    """ref/hist [..., T] -> (px_hist [..., N], af [..., N], thresh [...],
    ref_params [..., 2]).

    Given ``ref_params`` [..., 2] (shape, scale), the GPD fit on ref is
    skipped and those are used (reference ``_extremes_train_1d``,
    ``_adjustment.py:1078-1084``).  The threshold's quantiles, the CDF's
    ``1 + c z`` and the quantile function's ``loc + scale z`` are rounded
    once, as the JAX package's compiled core rounds them.
    """
    ct = torch.as_tensor(cluster_thresh, dtype=ref.dtype, device=ref.device)
    qt = torch.tensor([q_thresh], dtype=ref.dtype, device=ref.device)

    def subset_q(x):
        return nan_quantile(torch.where(x >= ct, x, torch.nan), qt, axis=-1)[..., 0]

    thresh = (subset_q(ref) + subset_q(hist)) / 2
    th = thresh[..., None]
    if ref_params is None:
        ref_c, ref_s = _fit(ref, thresh, ct, max_clusters)
    else:
        ref_c, ref_s = ref_params[..., 0], ref_params[..., 1]
    hist_c, hist_s = _fit(hist, thresh, ct, max_clusters)

    px_ref = torch.where(ref >= th, gpd_cdf(ref, ref_c[..., None], th, ref_s[..., None]), torch.nan)
    hist_ext = torch.where(hist >= th, hist, torch.nan)
    px_hist = torch.where(~torch.isnan(hist_ext), gpd_cdf(hist_ext, hist_c[..., None], th, hist_s[..., None]), torch.nan)

    pmax = torch.minimum(nanmax(px_ref, axis=-1), nanmax(px_hist, axis=-1))
    pmin = torch.maximum(nanmin(px_ref, axis=-1), nanmin(px_hist, axis=-1))
    common = (px_hist <= pmax[..., None]) & (px_hist >= pmin[..., None])
    px_hist = torch.where(common, px_hist, torch.nan)
    af = gpd_ppf(px_hist, ref_c[..., None], th, ref_s[..., None]) / hist_ext

    # sorted by px (NaNs last, ties in time order), cut to the static size
    order = torch.sort(torch.where(torch.isnan(px_hist), torch.inf, px_hist), dim=-1, stable=True).indices[..., :n_out]
    px_sorted = torch.gather(px_hist, -1, order)
    af_sorted = torch.gather(torch.where(torch.isnan(px_hist), torch.nan, af), -1, order)
    return px_sorted, af_sorted, thresh, torch.stack([ref_c, ref_s], dim=-1)


def _extremes_adjust_core(sim, scen, px_hist, af, thresh, cluster_thresh, frac, power, *, interp: str, extrapolation: str, max_clusters: int):
    """sim/scen [..., T] -> the second-order scen [..., T]: sim's tail
    mapped through the trained (px, af) table, blended into scen by
    ``transition = clip(((sim - thresh)+ / (max(sim) - thresh) / frac) **
    power, 0, 1)``.  The blend ``transition * scen_ext + (1 - transition) *
    scen`` is rounded once on its first product, as the JAX package's
    compiled core rounds it."""
    _check_leading(sim.shape[:-1], thresh.shape)
    scalar = lambda v: torch.as_tensor(v, dtype=sim.dtype, device=sim.device)  # noqa: E731
    th = thresh[..., None]
    c, s = _fit(sim, thresh, scalar(cluster_thresh), max_clusters)
    px_fut = gpd_cdf(sim, c[..., None], th, s[..., None])
    scen_ext = sim * interp1d_table(px_fut, px_hist, af, interp, extrapolation)

    smax = nanmax(sim, axis=-1, keepdims=True)
    transition = ((torch.clamp(sim - th, min=0) / (smax - th)) / scalar(frac)) ** scalar(power)
    transition = torch.clamp(transition, 0, 1)
    out = fma(transition, scen_ext, (1 - transition) * scen)
    return torch.where(torch.isnan(out), scen, out)


def _cluster_bound(T: int, q_thresh: float) -> int:
    """Static cluster-count bound: the reference's own over-allocation
    ``(1 - q_thresh) * T * 1.05`` (``adjustment.py:856``), safe because only
    qualifying clusters (maximum above the threshold) take a label
    (``ops/clusters.py``)."""
    return max(int((1 - q_thresh) * T * 1.05) + 8, 16)


def _ref_params_tensor(ref_params, like: torch.Tensor) -> torch.Tensor:
    """A previous training's fitted ref GPD (its Dataset, its ``ref_params``
    DataArray or an array [..., 2]) as a tensor like ``like``."""
    rp = ref_params["ref_params"] if hasattr(ref_params, "keys") else ref_params
    rp = rp.data if isinstance(rp, DataArray) else rp
    return as_tensor(rp, dtype=like.dtype, device=like.device)


class ExtremeValues(TrainAdjust):
    r"""Second-order adjustment of extreme values (Roy et al.; reference
    adjustment.py:745-930).

    Train: the tail threshold is the mean ``q_thresh`` quantile of ref and
    hist values at or above ``cluster_thresh``; Generalized Pareto
    distributions are fit on cluster maxima; factors map hist's tail onto
    ref's.  Adjust blends the tail correction into a first-order ``scen``
    with a smooth transition controlled by ``frac`` and ``power``.
    """

    _allow_diff_calendars = True

    @classmethod
    def _train(cls, ref: DataArray, hist: DataArray, *, cluster_thresh: str, ref_params: Any = None, q_thresh: float = 0.95):
        ct = convert_units_to(cluster_thresh, ref.units)
        refa, bdims, bcoords = to_compute(ref)
        hista = to_compute(hist)[0].to(refa.device)
        T = refa.shape[-1]
        N = int((1 - q_thresh) * T * 1.05)
        rp = None if ref_params is None else _ref_params_tensor(ref_params, refa)
        px_hist, af, thresh, ref_fit = _extremes_train_core(
            refa, hista, ct, q_thresh, rp, n_out=N, max_clusters=_cluster_bound(T, q_thresh)
        )
        qdims, qcoords = tuple(bdims) + ("quantiles",), {**bcoords, "quantiles": np.arange(N)}
        ds = Dataset(
            {
                "px_hist": DataArray(px_hist, qdims, qcoords, {"long_name": "Probability of historical extremes"}, "px_hist"),
                "af": DataArray(af, qdims, qcoords, {"standard_name": "Adjustment factors"}, "af"),
                "thresh": DataArray(thresh[..., None], tuple(bdims) + ("group",), {**bcoords, "group": np.array([1])}, {"units": ref.units}, "thresh"),
                "ref_params": DataArray(ref_fit, tuple(bdims) + ("gpd_param",), {**bcoords, "gpd_param": np.array(["c", "scale"])},
                                        {"long_name": "Fitted GPD parameters of ref cluster maxima"}, "ref_params"),
            }
        )
        return ds, {"cluster_thresh": float(ct), "q_thresh": q_thresh}

    def _adjust(self, sim: DataArray, scen: DataArray, *, frac: float | None = None, power: float | None = None,
                interp: str = "linear", extrapolation: str = "constant"):
        if frac is None or power is None:
            # reference adjustment.py:905-914: the defaults changed from
            # (0.25, 1) to (0.70, 3) in v0.6.1 and silent reliance on them warns
            warnings.warn(
                "No value was provided for the `frac` and/or `power` parameters; "
                "using the current defaults frac=0.70, power=3. Set them "
                "explicitly to silence this warning.",
                FutureWarning,
                stacklevel=2,
            )
        frac = 0.70 if frac is None else frac
        power = 3.0 if power is None else power
        sima = to_compute(sim)[0]
        scena = to_compute(scen)[0].to(sima.device)
        table = lambda k: as_tensor(self.ds[k].data, dtype=sima.dtype, device=sima.device)  # noqa: E731
        out = _extremes_adjust_core(
            sima, scena, table("px_hist"), table("af"), table("thresh")[..., 0], self.cluster_thresh, frac, power,
            interp=interp, extrapolation=extrapolation, max_clusters=_cluster_bound(sima.shape[-1], self.q_thresh),
        )
        return scen_like(sim, out)
