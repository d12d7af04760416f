"""Pre/post-processing operations.

Port of the part of reference ``processing.py`` + ``_processing.py`` that
the ported schemes and their users need: the dry-day preprocessing of
precipitation (jitter under or over a threshold, frequency adaptation),
standardization, rank reordering (the Schaake shuffle), stacking variables
into one array and back, the energy score, and the type-II DCT that
``properties.spectral_variance`` takes.  Normalization, period stacking,
the spectral filter and the rest are not ported yet (ROADMAP A7).

The random draws (jitter noise, adapt_freq's tie-break and noise) come from
``utils/rng.py``'s generator on the data's device.  Each core also takes
its uniform draws already made (``draws=``), and makes them through
:func:`_jitter_draws` / :func:`_adapt_freq_draws` otherwise.
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
from .utils.rng import next_generator
from .utils.tensor import as_tensor, input_tensor, nanmax, nanmin, nanstd
from .utils.units import convert_units_to

__all__ = [
    "adapt_freq",
    "escore",
    "jitter",
    "jitter_over_thresh",
    "jitter_under_thresh",
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


# ---------------------------------------------------------------------------
# adapt_freq — reference _processing.py:20-142, processing.py:50-121
# ---------------------------------------------------------------------------


def _adapt_freq_draws(simg):
    """The draws of one frequency adaptation of ``simg``: the rank
    tie-break noise U(0.1, 0.25) and the replacement noise U(0, 1)."""
    return _uniform(simg, 0.1, 0.25), _uniform(simg, 0.0, 1.0)


def _rank_random_tiebreak(v, noise):
    """Percentile rank in [0, 1] with random tie-breaking (reference
    utils.py:575-638, the use_random_tiebreak branch): ``noise`` in
    U(0.1, 0.25) is added to the integer ranks, which are then ranked again."""
    rnk = average_rank(v, axis=-1)
    rnk = average_rank(torch.where(torch.isnan(rnk), torch.nan, rnk + noise), axis=-1)
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


def _dct2(x, axis):
    """Orthonormal type-II DCT along ``axis``, through one FFT (Makhoul
    1980; reference processing.py:740-751): the even samples, then the odd
    ones reversed, transformed and turned by ``2 exp(-i pi k / 2N)``.  The
    inverse and ``spectral_filter`` are not ported yet (ROADMAP A7)."""
    x = torch.movedim(x, axis, -1)
    N = x.shape[-1]
    V = torch.fft.fft(torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1), dim=-1)
    k = torch.arange(N, dtype=x.dtype, device=x.device)
    out = torch.real(V * torch.polar(torch.full_like(k, 2.0), -torch.pi * k / (2 * N)))
    scale = torch.full_like(k, np.sqrt(1 / (2 * N)))
    scale[0] = np.sqrt(1 / (4 * N))
    return torch.movedim(out * scale, -1, axis)
