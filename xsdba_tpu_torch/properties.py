"""Statistical properties: the diagnostics layer (reference ``properties.py``).

The reference builds these on xclim's Indicator machinery; here a light
:class:`StatisticalProperty` wrapper carries the same metadata contract
(aspect, allowed groups, default measure) around plain compute functions
over :class:`~xsdba_tpu_torch.utils.container.DataArray`.  Every property
computes on its data's device (numpy data on the ``device`` option's
device) and returns a DataArray there.  The marginal and temporal ones are
gathers and reductions over static group or period indexes, with no loop
over groups or sites; the spatial ones build all-site matrices on the
device (the inter-site Spearman correlation is one ``torch.matmul`` of
centred ranks) and bin the pairs by distance on the host, as the reference
does.

The JAX package runs these bodies eagerly, so the port rounds every
operation (``nan_quantile(fused=False)``); its compiled helpers
(``linregress_field``, the GEV fits) are in ``ops/fitting.py``.
"""

from __future__ import annotations

import inspect
import operator

import numpy as np
import torch

from .models._wrap import grouped_var
from .ops.segment import gather_groups
from .utils.container import DataArray
from .utils.grouper import Grouper, period_blocks
from .utils.tensor import full_float32_matmul, input_tensor, nanmax, nanmin, nanstd, nanvar
from .utils.units import convert_units_to

__all__ = [
    "StatisticalProperty",
    "acf",
    "annual_cycle_amplitude",
    "annual_cycle_asymmetry",
    "annual_cycle_maximum",
    "annual_cycle_minimum",
    "annual_cycle_phase",
    "bivariate_spell_length_distribution",
    "bivariate_threshold_count",
    "corr_btw_var",
    "decorrelation_length",
    "first_eof",
    "mean",
    "mean_annual_phase",
    "mean_annual_range",
    "mean_annual_relative_range",
    "quantile",
    "relative_annual_cycle_amplitude",
    "relative_frequency",
    "return_value",
    "skewness",
    "spatial_correlogram",
    "spectral_variance",
    "spell_length_distribution",
    "std",
    "threshold_count",
    "transition_probability",
    "trend",
    "var",
]

_OPS = {">": operator.gt, "<": operator.lt, ">=": operator.ge, "<=": operator.le, "==": operator.eq, "!=": operator.ne,
        "gt": operator.gt, "lt": operator.lt, "ge": operator.ge, "le": operator.le, "eq": operator.eq, "ne": operator.ne}


class StatisticalProperty:
    """Wraps a compute function with the reference Indicator contract
    (``properties.py:41-113``): aspect in {marginal, temporal, multivariate,
    spatial}, allowed groups, a default measure name.  ``units`` is accepted
    and ignored, as the JAX package's ``StatisticalProperty`` does."""

    def __init__(self, identifier, aspect, compute, allowed_groups=None, measure="bias", units=None):
        self.identifier = identifier
        self.aspect = aspect
        self._compute = compute
        self.allowed_groups = allowed_groups
        self.measure = measure
        self.__doc__ = compute.__doc__

    def __call__(self, da, *args, **kwargs):
        if "group" in kwargs:
            group = kwargs["group"]
        else:
            # the compute function's own default (acf's is "time.season")
            p = inspect.signature(self._compute).parameters.get("group")
            group = p.default if p is not None and p.default is not inspect.Parameter.empty else "time"
        group = Grouper(group) if isinstance(group, str) else group
        if self.allowed_groups is not None and group.prop not in self.allowed_groups:
            raise ValueError(
                f"Grouping period {group.prop} is not allowed for property {self.identifier} "
                f"(needs one of {self.allowed_groups})."
            )
        kwargs["group"] = group
        out = self._compute(da, *args, **kwargs)
        out.attrs.setdefault("long_name", self.identifier)
        out.attrs["aspect"] = self.aspect
        return out

    def get_measure(self):
        from . import measures

        return getattr(measures, self.measure)


# -- shared pieces ------------------------------------------------------------


def _time_last(da: DataArray):
    """(data [..., T] as a tensor on its device, batch dims, batch coords)."""
    dac = da.move_dim_last("time")
    bdims = dac.dims[:-1]
    return input_tensor(dac.data), bdims, {d: dac.coords[d] for d in bdims if d in dac.coords}


def _take_padded(x, idx, fill):
    """x [..., T] at the -1 padded indexes idx [...I] -> [..., ...I], ``fill`` at -1."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=x.device)
    return torch.where(idx >= 0, x[..., torch.clamp(idx, 0, x.shape[-1] - 1)], fill)


def _group_periods(period_group, G):
    """[G, Pmax] positions of each group's periods, chronological, -1 padded
    (the reference's per-group ``flatnonzero(period_group == g)``)."""
    order = np.argsort(period_group, kind="stable")
    counts = np.bincount(period_group, minlength=G)
    idx = np.full((G, max(int(counts.max(initial=0)), 1)), -1, dtype=np.int64)
    slot = np.arange(len(order)) - np.repeat(np.cumsum(counts) - counts, counts)
    idx[period_group[order], slot] = order
    return idx


def _squeeze_group(out: DataArray, gi) -> DataArray:
    """Drop the one-element ``group`` dim of a ``group="time"`` result."""
    if gi.prop != "group":
        return out
    bdims = out.dims[:-1]
    return DataArray(out.data[..., 0], bdims, {d: out.coords[d] for d in bdims if d in out.coords}, out.attrs, out.name)


def _grouped_reduce(da: DataArray, group: Grouper, fn, units=None, name=None):
    gi = group.indexes(da.time)
    x, bdims, bcoords = _time_last(da)
    out = _squeeze_group(grouped_var(fn(gather_groups(x, gi.gather_idx)), bdims, bcoords, gi, name=name), gi)
    out.attrs["units"] = units if units is not None else da.units
    return out


def _nanargmax(x):
    """``jnp.nanargmax`` along the last axis: NaN skipped, the first index of
    ties, -1 on an all-NaN slice."""
    out = torch.argmax(torch.where(torch.isnan(x), -torch.inf, x), dim=-1)
    return torch.where(torch.isnan(x).all(dim=-1), -1, out)


def _nanargmin(x):
    out = torch.argmin(torch.where(torch.isnan(x), torch.inf, x), dim=-1)
    return torch.where(torch.isnan(x).all(dim=-1), -1, out)


def _nanquantile(x, q):
    """``jnp.nanquantile(x, q, axis=-1, keepdims=True)`` for a Python float q,
    as the JAX package's 64-bit mode computes it: the position ``q (n - 1)``
    among the n valid sorted values and the lerp ``high h + low (1 - h)``
    in float64, its product ``high h`` fused with the sum as XLA contracts
    it (``fma``), rounded to x's dtype at the end."""
    from .ops.cuda.fma_kernel import fma

    xs = torch.sort(x, dim=-1, stable=True).values.double()
    n = (~torch.isnan(xs)).sum(dim=-1, keepdim=True).double()
    pos = q * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    take = lambda i: torch.gather(xs, -1, torch.clamp(torch.minimum(i, n - 1), min=0).long())  # noqa: E731
    return fma(take(high), hw, take(low) * (1 - hw)).to(x.dtype)


def _make_cond(da, method, op, thresh):
    x, _, _ = _time_last(da)
    if method == "amount":
        t = convert_units_to(thresh, da.units)
    elif method == "quantile":
        t = _nanquantile(x, float(thresh))
    else:
        raise ValueError(f"Unknown method {method!r}")
    return _OPS[op](x, t)


# -- marginal -------------------------------------------------------------------


def _mean(da, *, group="time"):
    """Mean of the variable (reference properties.py:116-155)."""
    return _grouped_reduce(da, group, lambda v: torch.nanmean(v, dim=-1), name="mean")


def _var(da, *, group="time"):
    """Variance (reference properties.py:158-196)."""
    u = da.units
    out = _grouped_reduce(da, group, lambda v: nanvar(v, axis=-1), name="var")
    out.attrs["units"] = f"({u})2" if u else ""
    return out


def _std(da, *, group="time"):
    """Standard deviation (reference properties.py:199-235)."""
    return _grouped_reduce(da, group, lambda v: nanstd(v, axis=-1), name="std")


def _skewness(da, *, group="time"):
    """Fisher-Pearson skewness (scipy.stats.skew semantics; reference
    properties.py:238-257)."""

    def fn(v):
        mu = torch.nanmean(v, dim=-1, keepdim=True)
        sd = nanstd(v, axis=-1, keepdims=True)
        return torch.nanmean(((v - mu) / sd) ** 3, dim=-1)

    return _grouped_reduce(da, group, fn, units="", name="skewness")


def _quantile(da, *, q=0.98, group="time"):
    """Quantile q of the variable (reference properties.py:260-294)."""
    from .ops.quantile import nan_quantile

    return _grouped_reduce(da, group, lambda v: nan_quantile(v, [q], axis=-1, fused=False)[..., 0], name="quantile")


mean = StatisticalProperty("mean", "marginal", _mean)
var = StatisticalProperty("var", "marginal", _var)
std = StatisticalProperty("std", "marginal", _std)
skewness = StatisticalProperty("skewness", "marginal", _skewness)
quantile = StatisticalProperty("quantile", "marginal", _quantile)


# -- temporal -------------------------------------------------------------------


def _run_lengths(cond):
    """Lengths of the True runs of each row of cond [..., L], in order, -1
    padded to L // 2 + 1 (the most runs a row of L can hold): run ids by a
    cumulative sum of the run starts, and one ``scatter_add_`` over the
    flattened (row, run id) pairs, with no loop over rows and no host
    synchronisation."""
    L = cond.shape[-1]
    C = L // 2 + 1
    c = cond.reshape(-1, L)
    prev = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=-1)
    rid = torch.cumsum(c & ~prev, dim=-1) * c                      # 1-based run id, 0 outside runs
    flat = (torch.arange(c.shape[0], device=c.device)[:, None] * (C + 1) + rid).reshape(-1)
    counts = torch.zeros(c.shape[0] * (C + 1), dtype=torch.int64, device=c.device)
    counts.scatter_add_(0, flat, c.reshape(-1).to(torch.int64))
    counts = counts.reshape(c.shape[0], C + 1)[:, 1:]
    return torch.where(counts > 0, counts, -1).reshape(cond.shape[:-1] + (C,))


def _stat_reduce(x, stat):
    """``stat`` over the last axis, the -1 pads (and NaNs) left out."""
    x = torch.where(x < 0, torch.nan, x)
    if stat == "mean":
        return torch.nanmean(x, dim=-1)
    if stat == "sum":
        return torch.nansum(x, dim=-1)
    if stat == "max":
        return nanmax(x, axis=-1)
    if stat == "min":
        return nanmin(x, axis=-1)
    raise ValueError(f"Unknown stat {stat!r}")


def _periods_to_groups(per_period, period_group, group, da, stat, name, units):
    """``stat`` over each group's periods (per_period [..., P] -> [..., G]),
    one gather of a [G, Pmax] index for every group."""
    G = group.n_groups(da.time)
    vals = _take_padded(per_period, _group_periods(period_group, G), -1.0)
    vals = torch.where(torch.isnan(vals), -1.0, vals)
    _, bdims, bcoords = _time_last(da)
    gi = group.indexes(da.time)
    res = _squeeze_group(grouped_var(_stat_reduce(vals, stat), bdims, bcoords, gi, name=name), gi)
    res.attrs["units"] = units
    return res


def _spells(cond, time, prop, window, stat_resample, dtype):
    """The per-period statistic of the spell lengths: (per_period [..., P],
    period_group)."""
    gather, period_group = period_blocks(time, prop)
    lengths = _run_lengths(_take_padded(cond, gather, False)).to(dtype)       # [..., P, C]
    lengths = torch.where((lengths > 0) & (lengths < window), -1.0, lengths)
    return _stat_reduce(lengths, stat_resample), period_group


def _spell_length_distribution(da, *, method="amount", op=">=", thresh="1 mm d-1", window=1,
                               stat="mean", stat_resample=None, group="time"):
    """Statistic of the spell-length distribution (reference
    properties.py:297-422): per resample period, the lengths of the runs
    where the condition holds for at least ``window`` days;
    ``stat_resample`` over the spells of each period, ``stat`` over the
    periods of each group."""
    dtype = _time_last(da)[0].dtype
    per_period, period_group = _spells(_make_cond(da, method, op, thresh), da.time, group.prop, window, stat_resample or stat, dtype)
    return _periods_to_groups(per_period, period_group, group, da, stat, "spell_length_distribution", "d")


def _acf(da, *, lag=1, group="time.season"):
    """Lag-k autocorrelation per resample period, averaged over the periods
    of each group (statsmodels.acf semantics: overall-mean anomalies, n
    denominator; reference properties.py:485-545)."""
    x, bdims, bcoords = _time_last(da)
    gather, period_group = period_blocks(da.time, group.prop)
    xp = _take_padded(x, gather, torch.nan)                                     # [..., P, L]
    a = xp - torch.nanmean(xp, dim=-1, keepdim=True)
    var = torch.where(torch.isnan(a), 0.0, a * a).sum(dim=-1)
    a0 = torch.where(torch.isnan(a), 0.0, a)
    cov = (a0[..., lag:] * a0[..., :-lag]).sum(dim=-1)
    r = cov / torch.where(var == 0, 1.0, var)
    out = torch.nanmean(_take_padded(r, _group_periods(period_group, group.n_groups(da.time)), torch.nan), dim=-1)
    res = grouped_var(out, bdims, bcoords, group.indexes(da.time), name="acf")
    res.attrs["units"] = ""
    return res


def _doy_climatology(da, window):
    """Daily climatology [..., 365], smoothed by a circular rolling mean of
    ``window`` days."""
    gi = Grouper("time.dayofyear").indexes(da.time)
    x, bdims, bcoords = _time_last(da)
    clim = torch.nanmean(gather_groups(x, gi.gather_idx), dim=-1)[..., :365]
    if window > 1:
        h = window // 2
        pad = torch.cat([clim[..., -h:], clim, clim[..., :h]], dim=-1)
        clim = torch.nanmean(pad.unfold(-1, window, 1), dim=-1)
    return clim, bdims, bcoords


def _annual_cycle(da, *, stat="absamp", window=31, group="time"):
    """Annual-cycle statistics of the smoothed daily climatology (reference
    properties.py:548-676)."""
    clim, bdims, bcoords = _doy_climatology(da, window)
    mx, mn = nanmax(clim, axis=-1), nanmin(clim, axis=-1)
    allnan = torch.isnan(clim).all(dim=-1)
    units = da.units
    if stat == "absamp":
        out = mx - mn
    elif stat == "relamp":
        out = (mx - mn) * 100 / torch.nanmean(clim, dim=-1)
        units = "%"
    elif stat == "phase":
        # nanargmax is -1 on an all-NaN slice (an ocean site): NaN there
        out = torch.where(allnan, torch.nan, (_nanargmax(clim) + 1).to(clim.dtype))
        units = ""
    elif stat == "min":
        out = mn
    elif stat == "max":
        out = mx
    elif stat == "asymmetry":
        raw = ((_nanargmax(clim) - _nanargmin(clim)) % 365).double() / 365
        out = torch.where(allnan, torch.nan, raw.to(clim.dtype))
        units = "yr"
    else:
        raise ValueError(f"Unknown stat {stat!r}")
    return DataArray(out, bdims, bcoords, {"units": units}, f"annual_cycle_{stat}")


def _annual_statistic(da, *, stat="absamp", window=31, group="time"):
    """Mean annual range statistics of the rolling-smoothed series
    (reference properties.py:679-756): per-year max/min statistics averaged
    over the years."""
    x, bdims, bcoords = _time_last(da)
    if window > 1:
        h = window // 2
        pad = torch.cat([x[..., :1].expand(x.shape[:-1] + (h,)), x, x[..., -1:].expand(x.shape[:-1] + (h,))], dim=-1)
        x = torch.nanmean(pad.unfold(-1, window, 1), dim=-1)                  # edges repeat the end values
    gather, _ = period_blocks(da.time, "group")                               # yearly blocks
    xp = _take_padded(x, gather, torch.nan)                                   # [..., Y, L]
    mx, mn = nanmax(xp, axis=-1), nanmin(xp, axis=-1)
    units = da.units
    if stat == "absamp":
        out = torch.nanmean(mx - mn, dim=-1)
    elif stat == "relamp":
        out = torch.nanmean((mx - mn) * 100 / torch.nanmean(xp, dim=-1), dim=-1)
        units = "%"
    elif stat == "phase":
        doyp = _take_padded(torch.as_tensor(da.time.dayofyear, device=x.device), gather, 0).to(x.dtype)
        am = torch.argmax(torch.where(torch.isnan(xp), -torch.inf, xp), dim=-1, keepdim=True)
        per_year = torch.gather(doyp.expand(xp.shape), -1, am)[..., 0]
        # all-NaN years (or whole ocean sites) add no fake Jan-1 phase
        per_year = torch.where((~torch.isnan(xp)).any(dim=-1), per_year, torch.nan)
        out = torch.nanmean(per_year, dim=-1)
        units = ""
    else:
        raise ValueError(f"Unknown stat {stat!r}")
    return DataArray(out, bdims, bcoords, {"units": units}, f"mean_annual_{stat}")


def _relative_frequency(da, *, op=">=", thresh="1 mm d-1", group="time"):
    """Relative frequency of the condition per group (reference
    properties.py:1072-1127); the counts' ratio is taken in float64, as the
    JAX package's 64-bit mode divides integers, then rounded to the data's
    dtype."""
    t = convert_units_to(thresh, da.units)

    def fn(v):
        nan = torch.isnan(v)
        n = (~nan).sum(dim=-1)
        hits = (_OPS[op](v, t) & ~nan).sum(dim=-1)
        return (hits.double() / torch.where(n == 0, 1, n).double()).to(v.dtype)

    return _grouped_reduce(da, group, fn, units="", name="relative_frequency")


def _transition_probability(da, *, initial_op=">=", final_op=">=", thresh="1 mm d-1", group="time"):
    """P(state(t) & state(t+1)) per group (reference properties.py:1130-1186)."""
    t = convert_units_to(thresh, da.units)
    x, bdims, bcoords = _time_last(da)
    today, tomorrow = x[..., :-1], x[..., 1:]
    cond = (_OPS[initial_op](today, t) & _OPS[final_op](tomorrow, t)).to(x.dtype)
    cond = torch.where(torch.isnan(today) | torch.isnan(tomorrow), torch.nan, cond)
    sub = DataArray(cond, bdims + ("time",), {**bcoords, "time": da.time.isel(slice(0, -1))}, {"units": ""}, da.name)
    return _grouped_reduce(sub, group, lambda v: torch.nanmean(v, dim=-1), units="", name="transition_probability")


def _trend(da, *, group="time", output="slope"):
    """Interannual linear trend of per-period means (scipy.linregress
    attributes; reference properties.py:1189-1255): the period means of
    each group gathered into a [..., G, Pmax] block (chronological, NaN
    padded) and every regression in one ``linregress_field`` call."""
    from .ops.fitting import linregress_field

    x, bdims, bcoords = _time_last(da)
    gather, period_group = period_blocks(da.time, group.prop)
    pm = torch.nanmean(_take_padded(x, gather, torch.nan), dim=-1)              # [..., P]
    y = _take_padded(pm, _group_periods(period_group, group.n_groups(da.time)), torch.nan)  # [..., G, Pmax]
    t = torch.arange(y.shape[-1], dtype=y.dtype, device=y.device)             # the position in the group's periods
    gi = group.indexes(da.time)
    res = _squeeze_group(grouped_var(linregress_field(y, t, output), bdims, bcoords, gi, name="trend"), gi)
    res.attrs["units"] = f"{da.units}/year" if output == "slope" else ""
    return res


def _return_value(da, *, period=20, op="max", method="ML", group="time"):
    """T-year return value from a GEV fit on annual extremes (reference
    properties.py:1258-1307).  The extremes and every fit stay on the
    data's device: ML, PWM and MM through ``ops.fitting.gev_fit_{ml,pwm,mm}``,
    APP through its closed form (the reference's starting values,
    ``utils.py:1172-1185``: c = 0.1, Gumbel-moment loc and scale)."""
    from .ops.fitting import gev_fit_ml, gev_fit_mm, gev_fit_pwm, gev_ppf

    x, bdims, bcoords = _time_last(da)
    gather, _ = period_blocks(da.time, "group")
    xg = _take_padded(x, gather, torch.nan)
    extremes = nanmax(xg, axis=-1) if op == "max" else nanmin(xg, axis=-1)       # [..., Y]
    q = 1 - 1.0 / period if op == "max" else 1.0 / period
    if method in ("ML", "PWM", "MM"):
        c, loc, scale = {"ML": gev_fit_ml, "PWM": gev_fit_pwm, "MM": gev_fit_mm}[method](extremes)
    elif method == "APP":
        m, v = torch.nanmean(extremes, dim=-1), nanvar(extremes, axis=-1)
        scale = torch.sqrt(6 * v) / np.pi
        n_valid = (~torch.isnan(extremes)).sum(dim=-1)
        c = torch.where(n_valid < 2, torch.nan, torch.full_like(m, 0.1))
        loc = m - 0.57722 * scale
    else:
        raise ValueError(f"Unknown return_value fitting method {method!r} (ML, PWM, MM, APP).")
    return DataArray(gev_ppf(q, c, loc, scale), bdims, bcoords, {"units": da.units}, "return_value")


# -- multivariate / spatial -------------------------------------------------------


def _corr_btw_var(da1, da2, *, corr_type="Spearman", group="time", output="correlation"):
    """Correlation between two variables (reference properties.py:759-827)."""
    from .measures import _nan_pearson
    from .ops.rank import average_rank

    if corr_type not in ("Spearman", "Pearson"):
        raise ValueError(f"corr_type must be Spearman or Pearson, got {corr_type}")
    if output not in ("correlation", "pvalue"):
        raise ValueError(f"output must be 'correlation' or 'pvalue', got {output!r}")
    gi = group.indexes(da1.time)
    x, bdims, bcoords = _time_last(da1)
    y = _time_last(da2)[0].to(x.device)
    xg, yg = gather_groups(x, gi.gather_idx), gather_groups(y, gi.gather_idx)
    if corr_type == "Spearman":
        xg, yg = average_rank(xg, axis=-1), average_rank(yg, axis=-1)
    r = _nan_pearson(xg, yg)
    if output == "pvalue":
        # the two-sided t-test scipy's pearsonr / spearmanr apply: t = r sqrt((n-2)/(1-r^2))
        from .ops.fitting import betainc

        n = (~torch.isnan(xg) & ~torch.isnan(yg)).sum(dim=-1)
        df = torch.clamp(n - 2, min=1).to(r.dtype)
        t2 = df * r * r / torch.clamp(1.0 - r * r, min=torch.finfo(r.dtype).tiny)
        r = torch.where(n > 2, betainc(df / 2.0, torch.full_like(df, 0.5), df / (df + t2)), torch.nan)
    res = _squeeze_group(grouped_var(r, bdims, bcoords, gi, name="corr_btw_var"), gi)
    res.attrs["units"] = ""
    return res


def pairwise_haversine(lon, lat):
    """All-pairs great-circle distances in km (reference nbutils.py:419-445),
    float64 on the coordinates' device (tensors) or the CPU."""
    lon = torch.deg2rad(torch.as_tensor(lon, dtype=torch.float64))
    lat = torch.deg2rad(torch.as_tensor(lat, dtype=torch.float64, device=lon.device))
    dlon = lon[None, :] - lon[:, None]
    a = (torch.cos(lat[None, :]) * torch.sin(dlon)) ** 2 + (
        torch.cos(lat[:, None]) * torch.sin(lat[None, :]) - torch.sin(lat[:, None]) * torch.cos(lat[None, :]) * torch.cos(dlon)
    ) ** 2
    b = torch.sin(lat[:, None]) * torch.sin(lat[None, :]) + torch.cos(lat[:, None]) * torch.cos(lat[None, :]) * torch.cos(dlon)
    return 6367 * torch.atan2(torch.sqrt(a), b)


def _pairwise_spearman(x):
    """Inter-site Spearman correlation matrix of x [N, T] (reference
    utils.py:977-1025): average ranks, centred, and one ``torch.matmul`` of
    the [N, T] ranks with their transpose, in full float32 on the card
    (TF32 off)."""
    from .ops.rank import average_rank

    r = average_rank(x, axis=-1)
    r = r - torch.nanmean(r, dim=-1, keepdim=True)
    r0 = torch.where(torch.isnan(r), 0.0, r)
    with full_float32_matmul():
        cov = r0 @ r0.T
    d = torch.sqrt(torch.diagonal(cov))
    return cov / (d[:, None] * d[None, :])


def _site_matrices(da):
    """(distances [N, N], Spearman correlations [N, N]) of the sites, on the
    data's device; needs ``lon`` / ``lat`` coords on the site dim."""
    x, _, _ = _time_last(da)
    lon = torch.as_tensor(np.asarray(da.coords["lon"], dtype=np.float64).ravel(), device=x.device)
    lat = np.asarray(da.coords["lat"], dtype=np.float64).ravel()
    return pairwise_haversine(lon, lat), _pairwise_spearman(x.reshape(-1, x.shape[-1]))


def _spatial_correlogram(da, *, dims=None, bins=100, group="time", method=1):
    """Mean inter-site Spearman correlation binned by distance (reference
    properties.py:1321-1409).  The matrices are built on the device; the
    pairs are binned on the host, as the reference does."""
    dists, corr = _site_matrices(da)
    dev = dists.device
    dists, corr = dists.cpu().numpy(), corr.cpu().numpy()
    dmax = float(np.nanmax(dists))
    dmin = float(np.nanmin(np.where(dists == 0, np.nan, dists)))
    edges = np.linspace(dmin, dmax, bins + 1)
    centers = (edges[:-1] + edges[1:]) / 2
    iu = np.triu_indices(dists.shape[0], k=1)
    dv, cv = dists[iu], corr[iu]
    which = np.clip(np.digitize(dv, edges) - 1, 0, bins - 1)
    sums = np.bincount(which, weights=np.nan_to_num(cv), minlength=bins)
    cnts = np.bincount(which, weights=(~np.isnan(cv)).astype(float), minlength=bins)
    vals = np.where(cnts > 0, sums / np.where(cnts == 0, 1, cnts), np.nan)
    return DataArray(torch.as_tensor(vals, device=dev), ("distance_bins",), {"distance_bins": centers}, {"units": ""}, "spatial_correlogram")


def _decorrelation_length(da, *, radius=300, thresh=0.50, dims=None, bins=100, group="time"):
    """Distance at which the inter-site correlation drops below ``thresh``
    within ``radius`` (reference properties.py:1412-1537).  The matrices are
    built on the device; the (row, bin) binning runs on the host in one
    ``bincount``, as the reference does."""
    dists, corr = _site_matrices(da)
    dev = dists.device
    dists, corr = dists.cpu().numpy(), corr.cpu().numpy()
    edges = np.linspace(0, radius, bins + 1)
    centers = (edges[:-1] + edges[1:]) / 2
    N = dists.shape[0]
    m = (dists > 0) & (dists <= radius)
    which = np.clip(np.digitize(dists, edges) - 1, 0, bins - 1)
    rows = np.broadcast_to(np.arange(N)[:, None], dists.shape)
    flat = (rows * bins + which)[m]
    sums = np.bincount(flat, weights=np.nan_to_num(corr)[m], minlength=N * bins).reshape(N, bins)
    cnts = np.bincount(flat, weights=(~np.isnan(corr))[m].astype(float), minlength=N * bins).reshape(N, bins)
    prof = np.where(cnts > 0, sums / np.where(cnts == 0, 1, cnts), np.nan)
    with np.errstate(invalid="ignore"):
        below = prof < thresh
    out = np.where(below.any(axis=1), centers[np.argmax(below, axis=1)], radius)
    out = np.where(m.any(axis=1), out, np.nan)
    return DataArray(torch.as_tensor(out, device=dev), ("site",), {}, {"units": "km"}, "decorrelation_length")


def _spectral_variance(da, *, wavelength_range=None, dims=("lat", "lon"), delta=None, group="time"):
    """Mean DCT spectral variance over a normalized wavenumber band
    (reference properties.py:1557-1649)."""
    from .processing import _dct2

    x = input_tensor(da.data)
    axes = [da.dims.index(d) for d in dims]
    coeffs = x
    for a in axes:
        coeffs = _dct2(coeffs, a)
    var2 = coeffs**2
    alpha2 = np.zeros(tuple(x.shape[a] for a in axes))
    for pos, a in enumerate(axes):
        N = x.shape[a]
        shape = [1] * len(axes)
        shape[pos] = N
        alpha2 = alpha2 + ((np.arange(N) / N) ** 2).reshape(shape)
    alpha = np.sqrt(alpha2)
    if wavelength_range is not None and delta is not None:
        from .utils.units import str2quantity

        d = str2quantity(delta).to("m").magnitude
        lo, hi = sorted((2 * d / str2quantity(wavelength_range[0]).to("m").magnitude, 2 * d / str2quantity(wavelength_range[1]).to("m").magnitude))
    else:
        lo, hi = 0.0, 1.0
    full = [1] * x.ndim
    for a in axes:
        full[a] = x.shape[a]
    mask = (alpha >= lo) & (alpha <= hi)
    out = torch.where(torch.as_tensor(mask.reshape(full), device=x.device), var2, 0.0).sum(dim=tuple(axes)) / max(int(mask.sum()), 1)
    bdims = tuple(d for d in da.dims if d not in dims)
    bcoords = {d: da.coords[d] for d in bdims if d in da.coords}
    return DataArray(out, bdims, bcoords, {"units": f"({da.units})2" if da.units else ""}, "spectral_variance")


def _threshold_count(da, *, method="amount", op=">=", thresh="1 mm d-1", stat="mean", stat_resample=None, group="time"):
    """{stat} number of days per period meeting the condition (reference
    properties.py:422-482); float32 counts, as the reference makes them."""
    gather, period_group = period_blocks(da.time, group.prop)
    counts = _take_padded(_make_cond(da, method, op, thresh), gather, False).sum(dim=-1).to(torch.float32)
    return _periods_to_groups(counts, period_group, group, da, stat, "threshold_count", "d")


def _bivariate_spell_length_distribution(da1, da2, *, method1="amount", method2="amount", op1=">=", op2=">=",
                                         thresh1="1 mm d-1", thresh2="1 mm d-1", window=1, stat="mean",
                                         stat_resample=None, group="time"):
    """Spell lengths where BOTH variables' conditions hold (reference
    properties.py:830-977); float32 lengths, as the reference makes them."""
    cond1 = _make_cond(da1, method1, op1, thresh1)
    cond = cond1 & _make_cond(da2, method2, op2, thresh2).to(cond1.device)
    per_period, period_group = _spells(cond, da1.time, group.prop, window, stat_resample or stat, torch.float32)
    return _periods_to_groups(per_period, period_group, group, da1, stat, "bivariate_spell_length_distribution", "d")


def _bivariate_threshold_count(da1, da2, *, method1="amount", method2="amount", op1=">=", op2=">=",
                               thresh1="1 mm d-1", thresh2="1 mm d-1", stat="mean", stat_resample=None, group="time"):
    """Statistic of the number of time steps where both variables meet their
    conditions: ``bivariate_spell_length_distribution`` with ``window=1``
    (reference properties.py:981-1069)."""
    return _bivariate_spell_length_distribution(
        da1, da2, method1=method1, method2=method2, op1=op1, op2=op2, thresh1=thresh1, thresh2=thresh2,
        window=1, stat=stat, stat_resample=stat_resample, group=group,
    ).rename("bivariate_threshold_count")


def _first_eof(da, *, dims=None, kind="+", thresh=None, group="time"):
    """First Empirical Orthogonal Function over the spatial dims (the JAX
    package's own SVD-based property; the reference removed its eofs-based
    one, properties.py:1540-1554).

    - ``dims``: spatial dims to take the EOF over (default: every non-time
      dim); any other non-time dim is a batch dim.
    - ``kind``: "+" analyses additive anomalies ``x - mean_t(x)``; "*"
      relative anomalies ``x / mean_t(x) - 1`` (sites whose temporal mean is
      0 or not finite come back NaN).
    - ``thresh``: values below it are missing (precipitation-style
      masking).  Missing entries add zero anomaly; all-missing sites come
      back NaN.

    Output: the leading EOF pattern over ``dims`` (unit L2 norm, largest
    loading positive), with the explained-variance fraction in
    ``attrs["variance_fraction"]`` when there are no batch dims.
    """
    from .ops.pca import first_eof_pattern

    dims = [d for d in da.dims if d != "time"] if dims is None else list(dims)
    bdims = tuple(d for d in da.dims if d != "time" and d not in dims)
    dac = da.transpose(*bdims, *dims, "time")
    x = input_tensor(dac.data)
    if thresh is not None:
        x = torch.where(x >= convert_units_to(thresh, da.units), x, torch.nan)
    bshape = x.shape[: len(bdims)]
    sshape = x.shape[len(bdims):-1]
    S = int(np.prod(sshape)) if sshape else 1
    a = x.reshape(bshape + (S, x.shape[-1])).transpose(-1, -2)               # [..., T, S]
    mean = torch.nanmean(a, dim=-2, keepdim=True)
    if kind == "*":
        mean = torch.where(torch.isfinite(mean) & (mean != 0), mean, torch.nan)
        anom = a / mean - 1.0
    else:
        anom = a - mean
    v, var_frac = first_eof_pattern(anom)
    bcoords = {d: dac.coords[d] for d in bdims + tuple(dims) if d in dac.coords}
    res = DataArray(v.reshape(bshape + sshape), bdims + tuple(dims), bcoords, {"units": ""}, "first_eof")
    if not bdims:
        res.attrs["variance_fraction"] = float(var_frac)
    return res


def _annual(fn, stat):
    """The property computing ``fn`` with ``stat`` fixed."""
    return lambda da, **kw: fn(da, stat=stat, **{k: v for k, v in kw.items() if k != "stat"})


_YEAR = ["group"]
_PERIODS = ["group", "season", "month"]
spell_length_distribution = StatisticalProperty("spell_length_distribution", "temporal", _spell_length_distribution, allowed_groups=_PERIODS)
acf = StatisticalProperty("acf", "temporal", _acf, allowed_groups=["season", "month"])
annual_cycle_amplitude = StatisticalProperty("annual_cycle_amplitude", "temporal", _annual(_annual_cycle, "absamp"), allowed_groups=_YEAR)
relative_annual_cycle_amplitude = StatisticalProperty("relative_annual_cycle_amplitude", "temporal", _annual(_annual_cycle, "relamp"), allowed_groups=_YEAR, measure="ratio")
annual_cycle_phase = StatisticalProperty("annual_cycle_phase", "temporal", _annual(_annual_cycle, "phase"), allowed_groups=_YEAR, measure="circular_bias")
annual_cycle_asymmetry = StatisticalProperty("annual_cycle_asymmetry", "temporal", _annual(_annual_cycle, "asymmetry"), allowed_groups=_YEAR)
annual_cycle_minimum = StatisticalProperty("annual_cycle_minimum", "temporal", _annual(_annual_cycle, "min"), allowed_groups=_YEAR)
annual_cycle_maximum = StatisticalProperty("annual_cycle_maximum", "temporal", _annual(_annual_cycle, "max"), allowed_groups=_YEAR)
mean_annual_range = StatisticalProperty("mean_annual_range", "temporal", _annual(_annual_statistic, "absamp"), allowed_groups=_YEAR)
mean_annual_relative_range = StatisticalProperty("mean_annual_relative_range", "temporal", _annual(_annual_statistic, "relamp"), allowed_groups=_YEAR, measure="ratio")
mean_annual_phase = StatisticalProperty("mean_annual_phase", "temporal", _annual(_annual_statistic, "phase"), allowed_groups=_YEAR, measure="circular_bias")
relative_frequency = StatisticalProperty("relative_frequency", "temporal", _relative_frequency)
transition_probability = StatisticalProperty("transition_probability", "temporal", _transition_probability)
trend = StatisticalProperty("trend", "temporal", _trend)
return_value = StatisticalProperty("return_value", "temporal", _return_value, allowed_groups=_YEAR)
corr_btw_var = StatisticalProperty("corr_btw_var", "multivariate", _corr_btw_var)
spatial_correlogram = StatisticalProperty("spatial_correlogram", "spatial", _spatial_correlogram, allowed_groups=_YEAR)
decorrelation_length = StatisticalProperty("decorrelation_length", "spatial", _decorrelation_length, allowed_groups=_YEAR)
spectral_variance = StatisticalProperty("spectral_variance", "spatial", _spectral_variance, allowed_groups=_YEAR)
threshold_count = StatisticalProperty("threshold_count", "temporal", _threshold_count, allowed_groups=_PERIODS)
bivariate_spell_length_distribution = StatisticalProperty("bivariate_spell_length_distribution", "temporal", _bivariate_spell_length_distribution, allowed_groups=_PERIODS)
bivariate_threshold_count = StatisticalProperty("bivariate_threshold_count", "multivariate", _bivariate_threshold_count, allowed_groups=_PERIODS)
first_eof = StatisticalProperty("first_eof", "spatial", _first_eof, allowed_groups=_YEAR)
