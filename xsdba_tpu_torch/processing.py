"""Pre/post-processing operations.

Port of reference ``processing.py`` + ``_processing.py`` and the public
array utilities of reference ``utils.py``: the dry-day preprocessing of
precipitation (jitter under or over a threshold, frequency adaptation),
normalization and standardization, rank reordering (the Schaake shuffle),
stacking variables into one array and back, the energy score, the
log / logit transforms into an additive space, stacking overlapping
multi-year periods into a new dimension and back (the moving-window
adjustment of long scenarios), the DCT spectral filter, and the ranks,
sorts, clusters, group broadcasts and quantile-table lookups of the
public utilities.  Everything computes on the data's device (numpy data on
the ``device`` option's device); the calendar arithmetic of the period
stacking is host numpy.

The random draws (jitter noise, adapt_freq's tie-break and noise, the noise
of :func:`uniform_noise_like` and of :func:`rank`'s random tie-break) come
from ``utils/rng.py``'s generator on the data's device.  Each core also
takes its uniform draws already made (``draws=``), and makes them through
:func:`_jitter_draws` / :func:`_adapt_freq_draws` / :func:`_noise_draws`
otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.escore import escore as _escore_core
from .ops.quantile import vecquantiles
from .ops.rank import average_rank
from .ops.segment import gather_groups, scatter_back
from .utils.container import DataArray, Dataset
from .utils.formatting import update_history
from .utils.grouper import GroupIndexes, Grouper, parse_group
from .utils.profiling import span
from .utils.rng import next_generator
from .utils.tensor import as_tensor, input_tensor, nanmax, nanmin, nanstd
from .utils.units import convert_units_to

__all__ = [
    "adapt_freq",
    "broadcast",
    "escore",
    "estimate_delta_from_cf",
    "from_additive_space",
    "get_clusters",
    "grouped_time_indexes",
    "interp_on_quantiles",
    "jitter",
    "jitter_over_thresh",
    "jitter_under_thresh",
    "normalize",
    "rank",
    "reordering",
    "sort_along_dim",
    "spectral_filter",
    "stack_periods",
    "stack_variables",
    "standardize",
    "to_additive_space",
    "uniform_noise_like",
    "unstack_periods",
    "unstack_variables",
    "unstandardize",
]


def _scen_like(da: DataArray, values, name):
    from .models._wrap import scen_like

    out = scen_like(da, values, name=name)
    out.attrs.update(da.attrs)
    return out


def _uniform(x, low, high):
    """Uniform draws in [low, high) shaped like ``x``, from the stream's
    generator on x's device."""
    u = torch.rand(x.shape, dtype=x.dtype, device=x.device, generator=next_generator(x.device))
    return torch.clamp(u * (high - low) + low, min=low)


# ---------------------------------------------------------------------------
# jitter — reference processing.py:124-257
# ---------------------------------------------------------------------------


def _jitter_draws(x, lower, upper, lower_bnd, upper_bnd):
    """The draws of one jitter of ``x``: U(lower_bnd, lower) where ``lower``
    is set and U(upper, upper_bnd) where ``upper`` is (else None)."""
    under = _uniform(x, lower_bnd, lower) if lower is not None else None
    over = _uniform(x, upper, upper_bnd) if upper is not None else None
    return under, over


def _jitter_core(x, lower: float | None, upper: float | None, upper_bnd: float | None, draws=None, lower_bnd: float | None = None):
    """Replace values below ``lower`` with U(lower_bnd, lower) noise and
    values above ``upper`` with U(upper, upper_bnd) noise; NaN stays NaN.
    ``lower_bnd`` defaults to the dtype's machine epsilon (the noise stays
    strictly positive).  ``draws``: the (under, over) draws of
    :func:`_jitter_draws`, made here when None."""
    x = as_tensor(x)
    if upper is not None and upper_bnd is None:
        raise ValueError("`upper_bnd` must be given with `upper`.")
    lo_bnd = torch.finfo(x.dtype).eps if lower_bnd is None else lower_bnd
    under, over = _jitter_draws(x, lower, upper, lo_bnd, upper_bnd) if draws is None else draws
    out = x
    if lower is not None:
        out = torch.where(out < lower, as_tensor(under, device=x.device), out)
    if upper is not None:
        out = torch.where(out > upper, as_tensor(over, device=x.device), out)
    return torch.where(torch.isnan(x), torch.nan, out)


def jitter(x: DataArray, lower: str | None = None, upper: str | None = None, minimum: str | None = None, maximum: str | None = None) -> DataArray:
    """Jitter under ``lower`` and/or over ``upper`` (reference
    processing.py:124-224); ``minimum``/``maximum`` bound the noise."""
    lo = convert_units_to(lower, x.units) if lower is not None else None
    up = convert_units_to(upper, x.units) if upper is not None else None
    mn = convert_units_to(minimum, x.units) if minimum is not None else None
    mx = convert_units_to(maximum, x.units) if maximum is not None else None
    res = x.copy(data=_jitter_core(input_tensor(x.data), lo, up, mx, lower_bnd=mn))
    res.attrs["history"] = update_history(f"jitter(x, lower={lower}, upper={upper})", x)
    return res


def jitter_under_thresh(x: DataArray, thresh: str) -> DataArray:
    """Replace values below ``thresh`` with uniform noise in (0, thresh)
    (reference processing.py:227-257): removes the ties at zero before a
    multiplicative adjustment."""
    return jitter(x, lower=thresh)


def jitter_over_thresh(x: DataArray, thresh: str, upper_bnd: str) -> DataArray:
    """Replace values above ``thresh`` with uniform noise in (thresh,
    upper_bnd) (reference processing.py:198-224)."""
    return jitter(x, upper=thresh, maximum=upper_bnd)


def _noise_draws(x, low, high):
    """U(low, high) draws shaped like ``x``: the noise of
    :func:`uniform_noise_like` and of :func:`rank`'s random tie-break."""
    return _uniform(x, low, high)


def uniform_noise_like(da: DataArray, low: float = 1e-6, high: float = 1e-3) -> DataArray:
    """Uniform noise in [low, high) with da's shape and dtype (reference
    processing.py:304-320)."""
    x = input_tensor(da.data)
    return da.copy(data=_noise_draws(x, low, high))


# ---------------------------------------------------------------------------
# adapt_freq — reference _processing.py:20-142, processing.py:50-121
# ---------------------------------------------------------------------------


def _adapt_freq_draws(simg):
    """The draws of one frequency adaptation of ``simg``: the rank
    tie-break noise U(0.1, 0.25) and the replacement noise U(0, 1)."""
    return _uniform(simg, 0.1, 0.25), _uniform(simg, 0.0, 1.0)


def _rank_random_tiebreak(v, noise, pct: bool = True):
    """Rank along the last axis with random tie-breaking (reference
    utils.py:575-638, the use_random_tiebreak branch): ``noise`` in
    U(0.1, 0.25) is added to the integer ranks, which are then ranked again;
    with ``pct`` rescaled to a percentile rank in [0, 1]."""
    rnk = average_rank(v, axis=-1)
    rnk = average_rank(torch.where(torch.isnan(rnk), torch.nan, rnk + noise), axis=-1)
    if not pct:
        return rnk
    nvalid = (~torch.isnan(v)).sum(dim=-1, keepdim=True).to(v.dtype)
    rnk = rnk / torch.where(nvalid == 0, 1, nvalid)
    mn = nanmin(rnk, axis=-1, keepdims=True)
    mx = nanmax(rnk, axis=-1, keepdims=True)
    denom = torch.where(mx - mn == 0, 1, mx - mn)
    return mx * (rnk - mn) / denom


def _ecdf_lastaxis(v, thresh):
    le = torch.where(torch.isnan(v), 0, (v <= thresh).to(v.dtype)).sum(dim=-1)
    n = (~torch.isnan(v)).sum(dim=-1)
    return le / torch.where(n == 0, 1, n)


def _adapt_freq_grouped(refg, simg, thresh, P0_ref=None, P0_hist=None, pth=None, draws=None):
    """Frequency adaptation on gathered group rows [..., G, L] (reference
    ``_processing.py:74-135``): the fraction ``dP0 = (P0_hist -
    P0_ref)/P0_hist`` of below-threshold sim values with the smallest
    tie-broken ranks is replaced by U(thresh, pth) noise, where ``pth`` is
    ref's quantile at P0_hist.  ``draws``: those of :func:`_adapt_freq_draws`,
    made here when None.

    Returns (sim_ad [..., G, L], P0_ref, P0_hist, pth, dP0 each [..., G])."""
    simg = as_tensor(simg)
    dev = simg.device
    tiebreak, u = _adapt_freq_draws(simg) if draws is None else (as_tensor(d, device=dev) for d in draws)
    P0_sim = _ecdf_lastaxis(simg, thresh)
    P0_hist = P0_sim if P0_hist is None else as_tensor(P0_hist, device=dev)
    P0_ref = _ecdf_lastaxis(as_tensor(refg, device=dev), thresh) if P0_ref is None else as_tensor(P0_ref, device=dev)
    dP0 = torch.where(P0_hist == 0, torch.nan, (P0_hist - P0_ref) / torch.where(P0_hist == 0, 1, P0_hist))
    if pth is None:
        # the JAX package computes this eagerly: unfused (ROADMAP C11)
        pth = vecquantiles(as_tensor(refg, device=dev), P0_hist, axis=-1, fused=False)
        pth = torch.where(dP0 > 0, pth, torch.nan)
    else:
        pth = as_tensor(pth, device=dev)

    rnk = _rank_random_tiebreak(simg, tiebreak)
    no_adapt = (dP0 <= 0) | torch.isnan(dP0)
    ratio = torch.where(P0_hist == 0, torch.inf, P0_ref / torch.where(P0_hist == 0, 1, P0_hist))
    preserve = (rnk < (ratio * P0_sim)[..., None]) | (rnk > P0_sim[..., None]) | torch.isnan(simg)
    noise = (pth[..., None] - thresh) * u + thresh
    sim_ad = torch.where(no_adapt[..., None], simg, torch.where(preserve, simg, noise))
    return sim_ad, P0_ref, P0_hist, pth, dP0


def _adapt_freq_core(refa, sima, gi: GroupIndexes, thresh, draws=None):
    """Training-path adapt_freq over [..., T] tensors: gathers by group and
    returns the *gathered* adapted sim (the quantiles consume the gathered
    rows) and the per-group P0 and pth."""
    refg = gather_groups(refa, gi.gather_idx)
    simg = gather_groups(sima, gi.gather_idx)
    sim_ad, P0_ref, P0_hist, pth, _ = _adapt_freq_grouped(refg, simg, thresh, draws=draws)
    return sim_ad, P0_ref, P0_hist, pth


def _adapt_freq_apply_core(sima, gi: GroupIndexes, thresh, P0_ref, P0_hist, pth, draws=None):
    """Adjust-path adapt_freq with the trained P0 and pth (reference
    ``_adjustment.py:639-645``); returns the adapted time series."""
    simg = gather_groups(sima, gi.gather_idx)
    sim_ad, *_ = _adapt_freq_grouped(None, simg, thresh, P0_ref=P0_ref, P0_hist=P0_hist, pth=pth, draws=draws)
    return scatter_back(sim_ad, gi.group_idx, gi.scatter_slot)


@parse_group
def adapt_freq(ref: DataArray, sim: DataArray, *, group: str | Grouper = "time", thresh: str = "0 mm d-1") -> Dataset:
    """Adapt the frequency of below-threshold values of sim to match ref's
    (Themessl et al. 2012; reference processing.py:50-121).

    Returns a Dataset with ``sim_ad``, ``pth``, ``dP0``, ``P0_ref`` and
    ``P0_hist``."""
    from .models._wrap import grouped_var, scen_like

    group = Grouper(group) if isinstance(group, str) else group
    th = convert_units_to(thresh, sim.units)
    gi = group.indexes(sim.time)
    simc, refc = sim.move_dim_last("time"), ref.move_dim_last("time")
    sv = input_tensor(simc.data)
    refg = gather_groups(as_tensor(input_tensor(refc.data), device=sv.device), gi.gather_idx)
    sim_ad_g, P0_ref, P0_hist, pth, dP0 = _adapt_freq_grouped(refg, gather_groups(sv, gi.gather_idx), th)
    sim_ad = scatter_back(sim_ad_g, gi.group_idx, gi.scatter_slot)

    bdims = simc.dims[:-1]
    bcoords = {d: simc.coords[d] for d in bdims if d in simc.coords}
    out = Dataset(
        {
            "sim_ad": scen_like(sim, sim_ad, name="sim_ad"),
            "pth": grouped_var(pth, bdims, bcoords, gi, name="pth"),
            "dP0": grouped_var(dP0, bdims, bcoords, gi, name="dP0"),
            "P0_ref": grouped_var(P0_ref, bdims, bcoords, gi, name="P0_ref"),
            "P0_hist": grouped_var(P0_hist, bdims, bcoords, gi, name="P0_hist"),
        }
    )
    out["sim_ad"].attrs.update(sim.attrs)
    out["sim_ad"].attrs["history"] = update_history(f"adapt_freq(ref, sim, group={group.name!r}, thresh={thresh!r})", sim)
    return out


@parse_group
def normalize(data: DataArray, norm: DataArray | None = None, *, group: str | Grouper = "time", kind: str = "+") -> tuple[DataArray, DataArray]:
    """Remove the group-wise mean (kind-aware).  Returns (anomaly, norm)
    (reference processing.py:260-301)."""
    from .models._algos import broadcast_groups_core
    from .models._wrap import device_brackets, grouped_var
    from .ops.correction import apply_correction, invert

    group = Grouper(group) if isinstance(group, str) else group
    gi = group.indexes(data.time)
    datac = data.move_dim_last("time")
    x = input_tensor(datac.data)
    normv = torch.nanmean(gather_groups(x, gi.gather_idx), dim=-1) if norm is None else as_tensor(input_tensor(norm.data), device=x.device)
    factors = broadcast_groups_core(invert(normv, kind), device_brackets(gi, "nearest", device=x.device))
    bdims = datac.dims[:-1]
    bcoords = {d: datac.coords[d] for d in bdims if d in datac.coords}
    norm_da = grouped_var(normv, bdims, bcoords, gi, name="norm", attrs={"units": data.units})
    return _scen_like(data, apply_correction(x, factors, kind), data.name), norm_da


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
    NaNs sort last, ties keep their order (both sorts are stable, as the
    reference's ``jnp.sort`` is), and -0.0 ties with +0.0, so each zero
    keeps its sign where the reference puts it.  The span ``reorder``."""
    with span("reorder"):
        sim_sorted = torch.sort(sim, dim=-1, stable=True).values
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


# ---------------------------------------------------------------------------
# additive-space transforms — reference processing.py:492-733
# ---------------------------------------------------------------------------


def to_additive_space(
    data: DataArray,
    lower_bound: str,
    upper_bound: str | None = None,
    trans: str = "log",
    clip_next_to_bounds: str | None = None,
) -> DataArray:
    """Map a bounded variable into an additive space via log or logit
    (Alavoine & Grenier 2022; reference processing.py:492-612)."""
    lb = convert_units_to(lower_bound, data.units)
    ub = convert_units_to(upper_bound, data.units) if upper_bound is not None else None
    x = input_tensor(data.data)
    if clip_next_to_bounds is not None:
        if clip_next_to_bounds == "strict":
            if float(nanmin(x)) < lb or (ub is not None and float(nanmax(x)) > ub):
                raise ValueError("Data exceeds the given bounds and clip_next_to_bounds='strict'.")
        elif clip_next_to_bounds != "permissive":
            raise ValueError("clip_next_to_bounds must be None, 'strict' or 'permissive'.")
        # the bounds in float32, as the JAX package forms them
        eps = np.finfo(np.float32).eps
        span = (ub - lb) if ub is not None else max(abs(lb), 1.0)
        x = torch.clamp(x, min=float(lb + eps * span), max=float(ub - eps * span) if ub is not None else None)

    if trans == "log":
        out = torch.log(x - lb)
    elif trans == "logit":
        if ub is None:
            raise ValueError("`upper_bound` is required for the logit transform.")
        xp = (x - lb) / (ub - lb)
        out = torch.log(xp / (1 - xp))
    else:
        raise NotImplementedError("`trans` must be one of 'log' or 'logit'.")

    res = data.copy(data=out)
    res.attrs["xsdba_transform"] = trans
    res.attrs["xsdba_transform_lower"] = float(lb)
    if ub is not None:
        res.attrs["xsdba_transform_upper"] = float(ub)
    if "units" in res.attrs:
        res.attrs["xsdba_transform_units"] = res.attrs.pop("units")
        res.attrs["units"] = ""
    res.attrs["history"] = update_history(f"to_additive_space(data, trans={trans!r})", data)
    return res


def from_additive_space(
    data: DataArray,
    lower_bound: str | None = None,
    upper_bound: str | None = None,
    trans: str | None = None,
    units: str | None = None,
) -> DataArray:
    """Inverse of :func:`to_additive_space` (reference processing.py:615-733):
    the transform's parameters from ``data``'s attributes, or all given."""
    if trans is None and lower_bound is None and units is None:
        try:
            trans = data.attrs["xsdba_transform"]
            units = data.attrs["xsdba_transform_units"]
            lb = float(data.attrs["xsdba_transform_lower"])
            ub = float(data.attrs["xsdba_transform_upper"]) if trans == "logit" else None
        except KeyError as err:
            raise ValueError(
                f"Attribute {err!s} must be present on the input data or all parameters must be given as arguments."
            ) from err
    elif trans is not None and lower_bound is not None and units is not None and (upper_bound is not None or trans == "log"):
        lb = convert_units_to(lower_bound, units)
        ub = convert_units_to(upper_bound, units) if trans == "logit" else None
    else:
        raise ValueError("Either all parameters are attributes of data, or all are given as arguments.")

    x = input_tensor(data.data)
    if trans == "log":
        out = torch.exp(x) + lb
    elif trans == "logit":
        out = 1 / (1 + torch.exp(-x)) * (ub - lb) + lb
    else:
        raise NotImplementedError("`trans` must be one of 'log' or 'logit'.")

    res = data.copy(data=out)
    for k in ("xsdba_transform", "xsdba_transform_lower", "xsdba_transform_upper", "xsdba_transform_units"):
        res.attrs.pop(k, None)
    res.attrs["units"] = units
    res.attrs["history"] = update_history(f"from_additive_space(data, trans={trans!r})", data)
    return res


# ---------------------------------------------------------------------------
# stack_periods / unstack_periods — reference base.py:1072-1381
# ---------------------------------------------------------------------------


_UNIFORM_CALENDARS = ("noleap", "365_day", "all_leap", "366_day", "360_day")

_ANCHOR_MONTHS = {
    "JAN": 1, "FEB": 2, "MAR": 3, "APR": 4, "MAY": 5, "JUN": 6,
    "JUL": 7, "AUG": 8, "SEP": 9, "OCT": 10, "NOV": 11, "DEC": 12,
}


def _anchor_month(start_anchored: bool, anchor: str | None) -> int:
    """Effective start anchor month of a Y/Q/M offset: an end-anchored
    offset bins as the start-anchored one rooted a month later (YE-JUN
    periods are YS-JUL periods; the end anchor defaults to DEC)."""
    if start_anchored:
        return _ANCHOR_MONTHS[anchor.upper()] if anchor else 1
    am = _ANCHOR_MONTHS[anchor.upper()] if anchor else 12
    return am % 12 + 1


def _period_unit_ids(time, base: str, anchor_month: int):
    """Absolute integer id of the base-frequency period holding each time
    step (the reference's ``resample(...).groups`` anchoring,
    base.py:1198-1229)."""
    if base == "D":
        return time.ordinal.astype(np.int64)
    p = {"Y": 12, "A": 12, "Q": 3, "M": 1}[base]
    return (time.year.astype(np.int64) * 12 + (time.month - 1) - (anchor_month - 1)) // p


def _virtual_next_uid(time, base: str, anchor_month: int, srcfreq: str):
    """Unit id of the element one sampling step past the end (the
    reference's ``time2`` extra step, base.py:1188-1196)."""
    from .utils.calendar import TimeIndex, _ordinal_to_ymd

    if srcfreq == "MS":
        y, mo = divmod(int(time.year[-1]) * 12 + int(time.month[-1]), 12)
        ext = TimeIndex(np.array([y]), np.array([mo + 1]), np.array([1]), time.calendar, None)
    else:
        step = int(np.median(np.diff(time.ordinal))) if len(time) > 1 else 1
        y, mo, d = _ordinal_to_ymd(np.array([time.ordinal[-1] + step]), time.calendar)
        ext = TimeIndex(y, mo, d, time.calendar, None)
    return int(_period_unit_ids(ext, base, anchor_month)[0])


def stack_periods(
    da: DataArray,
    window: int = 30,
    stride: int | None = None,
    min_length: int | None = None,
    freq: str = "YS",
    dim: str = "period",
    align_days: bool = True,
    pad_value=np.nan,
) -> DataArray:
    """Stack (possibly overlapping) multi-period windows into a new
    ``period`` dimension (reference base.py:1072-1270).

    ``window``/``stride``/``min_length`` are in units of ``freq`` (any
    start- or end-anchored Y/Q/M offset, with anchors and multiples, and
    D).  Reversible with :func:`unstack_periods` when ``stride`` divides
    ``window`` into an odd number of parts.  The parameters are kept in
    attrs.  The windows are found on the host from the calendar; the data
    is copied into the stack on its device."""
    from .utils.calendar import date_range as _date_range
    from .utils.calendar import parse_offset

    stride = stride or window
    min_length = min_length or window
    if stride > window:
        raise ValueError(f"Stride must be less than or equal to window. Got {stride} > {window}.")

    time = da.time
    mult, base, start_anchored, anchor = parse_offset(freq)
    if base not in ("Y", "A", "Q", "M", "D"):
        raise NotImplementedError(f"stack_periods does not support base frequency {base!r}.")
    am = _anchor_month(start_anchored, anchor) if base != "D" else 1
    cal = time.calendar
    srcfreq = time.infer_freq() or "D"

    # day alignment (reference base.py:1160-1178)
    if srcfreq == "D" and align_days:
        if base in ("Y", "A") and cal not in _UNIFORM_CALENDARS:
            raise ValueError(
                f"Stacking {window}{freq} periods will result in unaligned day-of-year. "
                "Consider converting the calendar of your data to one with uniform year "
                "lengths, or pass `align_days=False` to disable this check."
            )
        if base in ("Q", "M") and window > 1 and cal != "360_day":
            raise ValueError(
                f"Stacking {window}{freq} periods will result in unaligned day-of-month. "
                "Consider using a 360_day calendar, or pass `align_days=False`."
            )

    dac = da.move_dim_last("time")
    x = input_tensor(dac.data)
    T = x.shape[-1]
    uid = _period_unit_ids(time, base, am)
    rel = uid - uid[0]
    rel_ext = _virtual_next_uid(time, base, am, srcfreq) - uid[0]

    stride_u, win_u, minl_u = stride * mult, window * mult, min_length * mult
    p_months = {"Y": 12, "A": 12, "Q": 3, "M": 1}.get(base)
    first_is_period_start = base == "D" or ((int(time.year[0]) * 12 + int(time.month[0]) - 1 - (am - 1)) % p_months == 0)

    segments = []
    k = 0
    while True:
        sidx = int(np.searchsorted(rel, k * stride_u, side="left"))
        if sidx >= T:
            break
        w0 = rel[sidx]  # a window anchors on the unit period of its stride start
        if rel_ext < w0 + (minl_u if min_length < window else win_u):  # the (min-)window is not complete
            break
        if sidx == 0 and base in ("Y", "A", "Q") and min_length == window and not first_is_period_start:
            # a fractionally incomplete first period (reference base.py:1216-1224)
            k += 1
            continue
        eidx = int(np.searchsorted(rel, w0 + win_u, side="left"))
        segments.append((sidx, min(eidx, T)))
        k += 1
    if not segments:
        raise ValueError("No complete periods found; series shorter than `min_length`.")

    lengths = [e - s for s, e in segments]
    L = max(lengths)
    out = torch.full(x.shape[:-1] + (len(segments), L), pad_value, dtype=x.dtype, device=x.device)
    for pnum, (s0, e0) in enumerate(segments):
        out[..., pnum, : e0 - s0] = x[..., s0:e0]

    # each period's bounds of its stride-long unit sections, for unstacking
    nwin = window // stride
    secbounds = []
    for s0, e0 in segments:
        rel2 = uid[s0:e0] - uid[s0]
        sb = [int(np.searchsorted(rel2, j * stride_u, side="left")) for j in range(nwin + 1)]
        sb[-1] = min(sb[-1], e0 - s0)
        secbounds.append(sb)

    coords = {c: v for c, v in dac.coords.items() if c != "time"}
    coords[dim] = np.array([f"{time.year[s0]:04d}-{time.month[s0]:02d}-{time.day[s0]:02d}" for s0, _ in segments])
    # a placeholder time coordinate (reference base.py:1256: `start`)
    coords["time"] = _date_range("1970-01-01", periods=L, freq=srcfreq, calendar=cal)
    res = DataArray(out, dac.dims[:-1] + (dim, "time"), coords, dict(da.attrs), da.name)
    res.attrs["_stack_periods"] = {
        "window": window,
        "stride": stride,
        "freq": freq,
        "segments": [list(se) for se in segments],
        "secbounds": secbounds,
        "T": T,
        "time_ymd": (time.year.copy(), time.month.copy(), time.day.copy()),
        "calendar": cal,
        "unequal_lengths": int(len(set(lengths)) > 1),
    }
    return res


def unstack_periods(da: DataArray, dim: str = "period") -> DataArray:
    """Inverse of :func:`stack_periods`: keep the centre-most stride of
    each window; the series' ends come from the first and last windows
    (reference base.py:1272-1381).  On the data's device."""
    params = da.attrs.get("_stack_periods")
    if params is None:
        raise ValueError("`da` must have been created by stack_periods (missing params attr).")
    window, stride = params["window"], params["stride"]
    if (window / stride) % 2 != 1:
        raise NotImplementedError(
            "`unstack_periods` can only work with a stride that divides the window "
            f"into an odd number of parts. Got {window} / {stride}."
        )
    segments, secbounds, T = params["segments"], params["secbounds"], params["T"]
    dac = da.move_dim_last("time")
    ax = dac.dims.index(dim)
    x = input_tensor(dac.data)
    out = torch.full(x.shape[:ax] + x.shape[ax + 1 : -1] + (T,), torch.nan, dtype=x.dtype, device=x.device)
    mid = (window // stride - 1) // 2
    for pnum, (s0, e0) in enumerate(segments):
        seg = x.select(ax, pnum)
        length = e0 - s0
        sb = secbounds[pnum]
        keep0 = 0 if pnum == 0 else min(sb[mid], length)
        keep1 = length if pnum == len(segments) - 1 else min(sb[mid + 1], length)
        out[..., s0 + keep0 : s0 + keep1] = seg[..., keep0:keep1]

    dims = tuple(d for d in dac.dims if d != dim)
    coords = {c: v for c, v in dac.coords.items() if c not in (dim, "time")}
    if "time_ymd" in params:
        from .utils.calendar import TimeIndex

        y, m, d = params["time_ymd"]
        coords["time"] = TimeIndex(y, m, d, params["calendar"], None)
    return DataArray(out, dims, coords, {k: v for k, v in da.attrs.items() if k != "_stack_periods"}, da.name)


def _dct2(x, axis):
    """Orthonormal type-II DCT along ``axis``, through one FFT (Makhoul
    1980; reference processing.py:740-751): the even samples, then the odd
    ones reversed, transformed and turned by ``2 exp(-i pi k / 2N)``."""
    x = torch.movedim(x, axis, -1)
    N = x.shape[-1]
    V = torch.fft.fft(torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1), dim=-1)
    k = torch.arange(N, dtype=x.dtype, device=x.device)
    out = torch.real(V * torch.polar(torch.full_like(k, 2.0), -torch.pi * k / (2 * N)))
    scale = torch.full_like(k, np.sqrt(1 / (2 * N)))
    scale[0] = np.sqrt(1 / (4 * N))
    return torch.movedim(out * scale, -1, axis)


def _idct2(X, axis):
    """Inverse of :func:`_dct2` (orthonormal type-III DCT) along ``axis``,
    through one inverse FFT (reference processing.py:754-768)."""
    X = torch.movedim(X, axis, -1)
    N = X.shape[-1]
    k = torch.arange(N, dtype=X.dtype, device=X.device)
    scale = torch.full_like(k, np.sqrt(1 / (2 * N)))
    scale[0] = np.sqrt(1 / (4 * N))
    Xu = X / scale
    Xrev = torch.cat([torch.zeros_like(Xu[..., :1]), Xu[..., 1:].flip(-1)], dim=-1)
    V = torch.complex(Xu, -Xrev) * torch.polar(torch.full_like(k, 0.5), torch.pi * k / (2 * N))
    v = torch.real(torch.fft.ifft(V, dim=-1))
    h = (N + 1) // 2
    x = torch.empty_like(X)
    x[..., ::2] = v[..., :h]
    x[..., 1::2] = v[..., h:].flip(-1)
    return torch.movedim(x, -1, axis)


def cos2_mask_func(da, low, high):
    """Cosine-squared low-pass mask (reference processing.py:950-984):
    1 below ``low``, a cos^2 ramp between, 0 above ``high``."""
    ramp = torch.cos(((da - low) / (high - low)) * (torch.pi / 2)) ** 2
    return torch.where(da < low, 1.0, torch.where(da > high, 0.0, ramp))


def estimate_delta_from_cf(da: DataArray) -> str:
    """Estimate the grid length scale from a latitude-like coordinate
    (reference processing.py:1042-1058: ``da.cf["Y"]``): a coordinate whose
    units are degrees-north (or named lat/latitude/y), its median spacing
    as a quantity string, degrees at 111.2 km a degree."""
    for name, coord in da.coords.items():
        attrs = getattr(coord, "attrs", {}) if hasattr(coord, "attrs") else {}
        units = attrs.get("units")
        if not (units in ("degrees", "degrees_north") or name in ("lat", "latitude", "y")):
            continue
        vals = np.sort(np.asarray(coord.data if hasattr(coord, "data") else coord, dtype=np.float64))
        if len(vals) < 2:
            continue
        # the median spacing: robust to duplicated values and to non-uniform
        # (Gaussian) grids, where the first gap misrepresents the grid
        diffs = np.diff(vals)
        step = float(np.median(diffs[diffs > 0])) if (diffs > 0).any() else 0.0
        if step == 0.0:
            raise ValueError(f"Coordinate {name!r} has no distinct values to estimate a grid spacing from.")
        if units in ("degrees", "degrees_north") or (units is None and name in ("lat", "latitude")):
            # a bare "y" on a projected grid is in meters and must say so
            return f"{step * 111.2} km"
        if units is None:
            raise ValueError(
                f"Coordinate {name!r} has no units attribute; set one (e.g. 'degrees_north', 'km') "
                "or pass `delta` explicitly."
            )
        return f"{step} {units}"
    raise ValueError("Could not find a latitude-like coordinate (units 'degrees_north' or name lat/latitude/y) to estimate the grid scale from.")


def spectral_filter(
    da: DataArray,
    dims: list[str],
    lam_long: str | None = None,
    lam_short: str | None = None,
    delta: str | None = None,
    alpha_low_high: tuple[float, float] | None = None,
    mask_func=cos2_mask_func,
) -> DataArray:
    """DCT low-pass filter over spatial dims (Denis et al. 2002; reference
    processing.py:1063-1161).  Bounds given either as wavelengths and the
    grid resolution ``delta`` (estimated from a latitude coordinate when
    omitted), or directly as normalized wavenumbers.  The transforms run
    by ``torch.fft`` on the data's device, in its dtype; the mask
    (``mask_func`` of the float64 radial wavenumber) too."""
    if isinstance(dims, str):
        dims = [dims]
    if alpha_low_high is not None:
        alpha_low, alpha_high = alpha_low_high
    else:
        if lam_long is None or lam_short is None:
            raise ValueError("Either `alpha_low_high` or (`lam_long`, `lam_short`) must be given.")
        if delta is None:
            delta = estimate_delta_from_cf(da)
        from .utils.units import str2quantity

        d = str2quantity(delta).to("m").magnitude
        alpha_low = 2 * d / str2quantity(lam_long).to("m").magnitude
        alpha_high = 2 * d / str2quantity(lam_short).to("m").magnitude

    x = input_tensor(da.data)
    axes = [da.dims.index(d) for d in dims]
    # the normalized radial wavenumber sqrt(sum_d (i_d / N_d)^2), broadcast
    # onto the data's shape
    alpha2 = torch.zeros([x.shape[a] if a in axes else 1 for a in range(x.ndim)], dtype=torch.float64, device=x.device)
    for a in axes:
        shape = [1] * x.ndim
        shape[a] = x.shape[a]
        alpha2 = alpha2 + ((torch.arange(x.shape[a], dtype=torch.float64, device=x.device) / x.shape[a]) ** 2).reshape(shape)
    mask = mask_func(torch.sqrt(alpha2), alpha_low, alpha_high).to(x.dtype)
    coeffs = x
    for a in axes:
        coeffs = _dct2(coeffs, a)
    out = coeffs * mask
    for a in axes:
        out = _idct2(out, a)
    res = da.copy(data=out)
    res.attrs["history"] = update_history(
        f"spectral_filter(da, dims={dims}, alpha=({float(alpha_low):.4g}, {float(alpha_high):.4g}))", da
    )
    return res


def grouped_time_indexes(times, group):
    """Integer time-index blocks of each group and windowed group (reference
    processing.py:829-918): (g_idxs [G, L], gw_idxs [G, Lw]), -1 padded:
    the Grouper's static lowering."""
    group = Grouper(group) if isinstance(group, str) else group
    gi_w = group.indexes(times)
    gi = Grouper(group.name).indexes(times) if group.window > 1 else gi_w
    return gi.gather_idx, gi_w.gather_idx


# ---------------------------------------------------------------------------
# public array utilities of reference utils.py
# ---------------------------------------------------------------------------


def rank(da: DataArray, dim: str = "time", pct: bool = False, use_random_tiebreak: bool = False) -> DataArray:
    """Rank data along a dimension (reference utils.py:575-638): average
    ranks from 1; with ``pct`` rescaled to span [0, 1].  With
    ``use_random_tiebreak`` noise in U(0.1, 0.25) (:func:`_noise_draws`)
    breaks ties on the integer ranks without reordering distinct values."""
    from .models._wrap import scen_like
    from .ops.rank import rank_pct_rescaled

    x = input_tensor(da.move_dim_last(dim).data)
    if use_random_tiebreak:
        out = _rank_random_tiebreak(x, _noise_draws(x, 0.1, 0.25), pct=pct)
    else:
        out = rank_pct_rescaled(x, axis=-1) if pct else average_rank(x, axis=-1)
    res = scen_like(da, out, name=da.name)
    res.attrs["units"] = ""
    return res


def sort_along_dim(da: DataArray, dim: str = "time") -> DataArray:
    """Sort values along a dimension, NaNs last (reference utils.py:516-542)."""
    return _scen_like(da, torch.sort(input_tensor(da.move_dim_last(dim).data), dim=-1, stable=True).values, da.name)


def get_clusters(data: DataArray, u1, u2, dim: str = "time") -> Dataset:
    """Clusters along ``dim``: their start, end, position and value of the
    maximum, and the count (reference utils.py:844-921), through
    ``ops/clusters.py`` on the data's device."""
    from .ops.clusters import cluster_fields

    dac = data.move_dim_last(dim)
    x = input_tensor(dac.data)
    fields = cluster_fields(x, u1, u2, max_clusters=x.shape[-1] // 2)
    bdims = dac.dims[:-1]
    bcoords = {d: dac.coords[d] for d in bdims if d in dac.coords}
    C = fields["start"].shape[-1]
    mk = lambda v, nm: DataArray(v, bdims + ("cluster",), {**bcoords, "cluster": np.arange(C)}, {}, nm)  # noqa: E731
    return Dataset(
        {
            "start": mk(fields["start"], "start"),
            "end": mk(fields["end"], "end"),
            "maxpos": mk(fields["maxpos"], "maxpos"),
            "maximum": mk(fields["maximum"], "maximum"),
            "nclusters": DataArray(fields["nclusters"], bdims, bcoords, {}, "nclusters"),
        }
    )


@parse_group
def broadcast(
    grouped: DataArray,
    x: DataArray,
    *,
    group: str | Grouper = "time",
    interp: str = "nearest",
    sel: dict[str, DataArray] | None = None,
) -> DataArray:
    """Broadcast a grouped array ([..., prop]) onto ``x``'s time axis
    (reference utils.py:181-248): nearest selection by group id, or linear
    interpolation over the fractional group index with cyclic padding.
    ``sel`` maps further grouped dims to per-time coordinates of ``x``
    (e.g. ``{"quantiles": sim_rank}``), consumed by pointwise nearest
    selection or linear interpolation (NaN outside the coordinate's span)."""
    from .ops.correction import broadcast_group_factors

    group = Grouper(group) if isinstance(group, str) else group
    gi = group.indexes(x.time)
    gc = grouped.move_dim_last(group.prop_name if gi.prop != "group" else "group")
    f = input_tensor(gc.data)
    out = broadcast_group_factors(f, gi.frac_idx, gi.group_idx, gi.positions, interp=interp)
    bdims = gc.dims[:-1]
    for key, selda in (sel or {}).items():
        if key not in bdims:
            raise ValueError(f"sel key {key!r} is not a dimension of the grouped array {bdims}.")
        coord = torch.as_tensor(np.asarray(gc.coords[key], dtype=np.float64), dtype=out.dtype, device=out.device)
        sc = selda.move_dim_last("time") if "time" in selda.dims else selda
        tgt_dims = tuple(d for d in bdims if d != key) + ("time",)
        vshape = [1] * len(tgt_dims)
        for d, n in zip(sc.dims, np.shape(sc.data)):
            if d not in tgt_dims:
                raise ValueError(f"sel value for {key!r} has unknown dim {d!r}.")
            vshape[tgt_dims.index(d)] = n
        vals = as_tensor(input_tensor(sc.data), dtype=out.dtype, device=out.device).reshape(vshape)
        moved = torch.movedim(out, bdims.index(key), -1)  # (bdims - key) + (time, K)
        vals = vals.expand(moved.shape[:-1])
        if interp == "nearest":
            idx = torch.argmin(torch.abs(coord - vals[..., None]), dim=-1)
            out = torch.gather(moved, -1, idx[..., None])[..., 0]
        else:
            hi = torch.clamp(torch.searchsorted(coord, vals.contiguous()), 1, coord.shape[0] - 1)
            lo = hi - 1
            clo, chi = coord[lo], coord[hi]
            w = torch.clamp((vals - clo) / torch.where(chi == clo, 1.0, chi - clo), 0.0, 1.0)
            vlo = torch.gather(moved, -1, lo[..., None])[..., 0]
            vhi = torch.gather(moved, -1, hi[..., None])[..., 0]
            out = vlo * (1 - w) + vhi * w
            # xarray's .interp gives NaN outside the coordinate's span
            out = torch.where((vals < coord[0]) | (vals > coord[-1]), torch.nan, out)
        bdims = tuple(d for d in bdims if d != key)
    coords = {d: gc.coords[d] for d in bdims if d in gc.coords}
    coords["time"] = x.time
    return DataArray(out, bdims + ("time",), coords, dict(grouped.attrs), grouped.name)


@parse_group
def interp_on_quantiles(
    newx: DataArray,
    xq: DataArray,
    yq: DataArray,
    *,
    group: str | Grouper = "time",
    method: str = "linear",
    extrapolation: str = "constant",
    mode: str = "blend",
) -> DataArray:
    """Public grouped or ungrouped quantile-table interpolation (reference
    utils.py:409-513).

    ``mode="blend"`` (the default) looks up the two bracketing groups'
    tables of each time step and blends them cyclically
    (``ops/interp.py:interp_on_quantiles_grouped``: the row lookup kernel
    on partition rows where it serves); ``mode="reference"`` evaluates the
    reference's scipy-griddata triangulation on the host.  The ungrouped
    lookup is ``interp1d_table`` either way (the 2-D lookup kernel where it
    serves)."""
    from .models._wrap import scen_like
    from .ops.interp import interp1d_table, interp_on_quantiles_grouped, interp_on_quantiles_reference
    from .utils.tensor import to_numpy

    if mode not in ("blend", "reference"):
        raise ValueError(f"Unknown interpolation mode {mode!r} (blend, reference).")
    group = Grouper(group) if isinstance(group, str) else group
    v = input_tensor(newx.move_dim_last("time").data)
    xqv = as_tensor(input_tensor(xq.data), device=v.device)
    yqv = as_tensor(input_tensor(yq.data), device=v.device)
    grouped = not (group.prop == "group" or (group.prop_name not in xq.dims and group.prop_name not in yq.dims))
    if not grouped:
        out = interp1d_table(v, xqv, yqv, method, extrapolation)
    else:
        gi = group.indexes(newx.time)
        G = len(gi.positions)
        # reference utils.py:476-480: a table without the group dim is every group's
        if group.prop_name not in xq.dims:
            xqv = xqv[..., None, :].expand(xqv.shape[:-1] + (G,) + xqv.shape[-1:])
        if mode == "reference":
            newg = gi.frac_idx if method != "nearest" else gi.positions[gi.group_idx]
            ref = interp_on_quantiles_reference(
                to_numpy(v).astype(np.float64), newg, to_numpy(xqv).astype(np.float64), to_numpy(yqv).astype(np.float64),
                gi.positions, method=method, extrap=extrapolation,
            )
            out = torch.as_tensor(ref, dtype=v.dtype, device=v.device)
        else:
            out = interp_on_quantiles_grouped(v, gi.frac_idx, xqv, yqv, gi.positions, method, extrapolation)
    return scen_like(newx, out, name=newx.name)
