"""The port's statistical properties against the JAX package, on the CPU.

The same seeded numpy inputs (4 sites × 6 noleap years of tas and pr, with
a NaN gap and an all-NaN site) go through every property of both packages,
at each of its allowed groups, in float64 and float32.

Tolerances.  What involves no floating-point sum is equal under ``==``:
the quantile (the reference's eager ``nan_quantile``, unfused), the
longest spells, the counts and frequencies, the transition probabilities,
the annual-cycle phases and asymmetry, the spatial binning and the run
lengths.  The rest differ by the summation order of two libraries'
reductions: float64 holds 1e-12 relative, float32 2e-6, each with an
absolute part of the same size times the result's largest magnitude (a
skewness or a slope near 0 carries the rounding of the sums it cancels).
Where float32 cancels much more than that (the skewness, the
autocorrelation, the trend, the correlations' p-values and the EOF), the
port is held to the reference's float64 result of the same float32 data,
no further from it than three times the largest error of the
reference's own float32 result over the same array, plus 2e-6 relative
(both packages' float32 results scatter around the float64 one by their
own summation orders).  ``return_value`` follows ``test_torch_fitting.py``: its ML
fit holds 1e-6 relative in float64, and in float32 (where the reference's
ML fit raises in 64-bit mode, ROADMAP C20) 1e-3 relative to the
reference's float64 fit of the same values.
"""

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu import properties as jp
from xsdba_tpu_torch import properties as tp

F64, F32 = 1e-12, 2e-6
S, Y = 4, 6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


def _series():
    """(tas [S, T] K, pr [S, T] mm/d): a seasonal cycle, a warming, wet and
    dry days, a 40-day NaN gap at site 1 and an all-NaN site 2."""
    rng = np.random.default_rng(3)
    T = 365 * Y
    tas = 280 + 8 * np.sin(2 * np.pi * np.arange(T) / 365)[None] + rng.normal(0, 2, (S, T)) + 0.3 * np.arange(T) / 365
    pr = rng.gamma(0.8, 4, (S, T)) * (rng.random((S, T)) < 0.6)
    for a in (tas, pr):
        a[1, 100:140] = np.nan
        a[2] = np.nan
    return tas, pr


TAS, PR = _series()


def _das(x, units, name="v"):
    """The same [site, time] data as a DataArray of each package."""
    return tuple(
        mod.DataArray(x, ("site", "time"), {"time": mod.date_range("2000-01-01", periods=x.shape[-1], freq="D", calendar="noleap")}, {"units": units}, name)
        for mod in (xt, xp)
    )


def _np(da):
    return np.asarray(da.data.numpy() if isinstance(da.data, torch.Tensor) else da.data, dtype=np.float64)


def _close(got, want, rtol):
    atol = rtol * np.nanmax(np.abs(want)) if np.isfinite(want).any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


def _no_worse(got, want32, want64):
    """The port's float32 result no further from the reference's float64
    result than three times the reference's largest float32 error over the
    array, plus 2e-6."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want64))
    bound = 3 * np.nanmax(np.abs(want32 - want64)) + F32 * np.abs(want64) + F32 * np.nanmax(np.abs(want64))
    ok = np.isnan(want64) | (np.abs(got - want64) <= bound)
    assert ok.all(), (got[~ok], want64[~ok], want32[~ok])


# groups of the properties that take any: the whole series and the months
ALL = ["time", "time.month"]
PERIODS = ["time", "time.month", "time.season"]
# (property, keywords, variable, groups, comparison): "exact", "close" or "cancels"
CASES = [
    ("mean", {}, "tas", ALL, "close"),
    ("var", {}, "tas", ALL, "close"),
    ("std", {}, "tas", ALL, "close"),
    ("skewness", {}, "tas", ALL, "cancels"),
    ("quantile", {"q": 0.98}, "tas", ALL, "exact"),
    ("spell_length_distribution", {"thresh": "1 mm/d"}, "pr", PERIODS, "close"),
    ("spell_length_distribution", {"thresh": "1 mm/d", "stat": "max", "window": 2}, "pr", PERIODS, "exact"),
    ("spell_length_distribution", {"method": "quantile", "thresh": 0.8, "op": "<", "stat": "sum", "stat_resample": "mean"}, "pr", PERIODS, "close"),
    ("spell_length_distribution", {"thresh": "2 mm/d", "stat": "min", "stat_resample": "max"}, "pr", ["time.month"], "exact"),
    ("acf", {}, "tas", ["time.month", "time.season"], "cancels"),
    ("acf", {"lag": 3}, "tas", ["time.season"], "cancels"),
    ("annual_cycle_amplitude", {}, "tas", ["time"], "close"),
    ("relative_annual_cycle_amplitude", {}, "tas", ["time"], "close"),
    ("annual_cycle_phase", {}, "tas", ["time"], "exact"),
    ("annual_cycle_asymmetry", {}, "tas", ["time"], "exact"),
    ("annual_cycle_minimum", {"window": 5}, "tas", ["time"], "close"),
    ("annual_cycle_maximum", {}, "tas", ["time"], "close"),
    ("mean_annual_range", {}, "tas", ["time"], "close"),
    ("mean_annual_relative_range", {"window": 7}, "tas", ["time"], "close"),
    ("mean_annual_phase", {}, "tas", ["time"], "exact"),
    ("relative_frequency", {"thresh": "1 mm/d"}, "pr", ALL, "exact"),
    ("relative_frequency", {"op": "<", "thresh": "0.5 mm/d"}, "pr", ["time.month"], "exact"),
    ("transition_probability", {"thresh": "1 mm/d"}, "pr", ALL, "exact"),
    ("transition_probability", {"initial_op": "<", "final_op": ">=", "thresh": "1 mm/d"}, "pr", ["time.season"], "exact"),
    ("trend", {}, "tas", ALL, "cancels"),
    ("trend", {"output": "intercept"}, "tas", ["time.month"], "close"),
    ("trend", {"output": "pvalue"}, "tas", ["time", "time.season"], "cancels"),
    ("threshold_count", {"thresh": "1 mm/d"}, "pr", PERIODS, "exact"),
    ("threshold_count", {"thresh": "1 mm/d", "stat": "max", "stat_resample": "sum"}, "pr", PERIODS, "exact"),
    ("threshold_count", {"method": "quantile", "thresh": 0.9, "stat": "sum"}, "pr", ["time.season"], "exact"),
    ("return_value", {"method": "PWM"}, "tas", ["time"], "close"),
    ("return_value", {"method": "MM"}, "tas", ["time"], "close"),
    ("return_value", {"method": "APP", "op": "min", "period": 10}, "tas", ["time"], "close"),
    ("return_value", {"method": "ML"}, "tas", ["time"], "fit"),
]
PARAMS = [pytest.param(name, kw, v, g, how, id=f"{name}-{i}-{g}") for i, (name, kw, v, groups, how) in enumerate(CASES) for g in groups]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,kw,var,group,how", PARAMS)
def test_property_matches_reference(name, kw, var, group, how, dtype):
    x, units = (TAS, "K") if var == "tas" else (PR, "mm/d")
    jda, tda = _das(x.astype(dtype), units)
    got = getattr(tp, name)(tda, group=group, **kw)
    assert isinstance(got.data, torch.Tensor) and got.dims[0] == "site"
    g = _np(got)
    if name == "return_value" and how == "fit":
        want64 = _np(getattr(jp, name)(_das(x.astype(dtype).astype(np.float64), units)[0], group=group, **kw))
        np.testing.assert_allclose(g, want64, rtol=1e-6 if dtype == np.float64 else 1e-3, equal_nan=True)
        return
    want = getattr(jp, name)(jda, group=group, **kw)
    assert got.dims == want.dims and got.attrs["units"] == want.attrs["units"] and got.attrs["aspect"] == want.attrs["aspect"]
    w = _np(want)
    if how == "exact":
        np.testing.assert_array_equal(g, w.astype(got.data.numpy().dtype).astype(np.float64))
    elif dtype == np.float64:
        _close(g, w, F64)
    elif how == "close":
        _close(g, w, F32)
    else:
        _no_worse(g, w, _np(getattr(jp, name)(_das(x.astype(np.float32).astype(np.float64), units)[0], group=group, **kw)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("corr_type", ["Spearman", "Pearson"])
@pytest.mark.parametrize("output", ["correlation", "pvalue"])
@pytest.mark.parametrize("group", ["time", "time.month"])
def test_corr_btw_var_matches_reference(dtype, corr_type, output, group):
    (j1, t1), (j2, t2) = _das(TAS.astype(dtype), "K"), _das(PR.astype(dtype), "mm/d")
    kw = dict(corr_type=corr_type, output=output, group=group)
    g, w = _np(tp.corr_btw_var(t1, t2, **kw)), _np(jp.corr_btw_var(j1, j2, **kw))
    if dtype == np.float64:
        _close(g, w, F64)
    elif output == "correlation":
        _close(g, w, F32)
    else:
        (k1, _), (k2, _) = _das(TAS.astype(dtype).astype(np.float64), "K"), _das(PR.astype(dtype).astype(np.float64), "mm/d")
        _no_worse(g, w, _np(jp.corr_btw_var(k1, k2, **kw)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["bivariate_spell_length_distribution", "bivariate_threshold_count"])
@pytest.mark.parametrize("group", ["time", "time.season", "time.month"])
def test_bivariate_properties_match_reference(dtype, name, group):
    """float32 lengths and counts in both packages, whatever the data's dtype."""
    x = PR.astype(dtype)
    (j1, t1), (j2, t2) = _das(x, "mm/d"), _das(x[:, ::-1].copy(), "mm/d")
    kw = dict(thresh1="1 mm/d", thresh2="0.5 mm/d", group=group, stat="mean")
    got, want = getattr(tp, name)(t1, t2, **kw), getattr(jp, name)(j1, j2, **kw)
    assert got.data.dtype == torch.float32 and got.name == want.name and got.attrs["aspect"] == want.attrs["aspect"]
    _close(_np(got), _np(want), F32)


def _grid(dtype, n=12, T=400):
    rng = np.random.default_rng(5)
    lon, lat = rng.uniform(0, 3, n), rng.uniform(40, 43, n)
    x = rng.normal(size=T)[None] * rng.uniform(0.2, 1.0, (n, 1)) + rng.normal(0, 1.0, (n, T))
    x[3, :50] = np.nan
    return tuple(
        mod.DataArray(x.astype(dtype), ("site", "time"), {"time": mod.date_range("2000-01-01", periods=T, freq="D", calendar="noleap"), "lon": lon, "lat": lat}, {"units": "K"}, "tas")
        for mod in (xt, xp)
    )


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,kw", [
    ("spatial_correlogram", dict(bins=20)),
    ("decorrelation_length", dict(bins=20)),
    ("decorrelation_length", dict(radius=150, thresh=0.3, bins=10)),
])
def test_spatial_properties_match_reference(dtype, name, kw):
    """The matrices on the device, the binning on the host: equal, but for
    the float32 correlogram's binned values.  Those are means of the
    float32 rank product, whose summation order follows the CPU's GEMM
    (on one CPU 9 of 20 bins differ by up to 1.9e-8), so they are held at
    F32 (2e-6), as ``test_pairwise_matrices_match_reference`` holds the
    product itself.  Counts and coordinates stay equal."""
    jda, tda = _grid(dtype)
    got, want = getattr(tp, name)(tda, **kw), getattr(jp, name)(jda, **kw)
    assert got.dims == want.dims and got.attrs == want.attrs
    if dtype is np.float32 and name == "spatial_correlogram":
        _close(_np(got), _np(want), F32)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))
    for c in got.coords:
        np.testing.assert_array_equal(np.asarray(got.coords[c]), np.asarray(want.coords[c]))


@pytest.mark.parametrize("dtype,rtol", [(np.float64, F64), (np.float32, F32)])
def test_pairwise_matrices_match_reference(dtype, rtol):
    jda, tda = _grid(dtype)
    lon, lat = np.asarray(jda.coords["lon"]), np.asarray(jda.coords["lat"])
    _close(tp.pairwise_haversine(lon, lat).numpy(), np.asarray(jp.pairwise_haversine(lon, lat)), F64)
    _close(tp._pairwise_spearman(torch.from_numpy(tda.data)).numpy(), np.asarray(jp._pairwise_spearman(jda.data)), rtol)


def _field(dtype, batch=True, offset=0.0):
    """[member 2,] lat 8, lon 16, time 30 with a NaN point."""
    x = np.random.default_rng(6).normal(size=(2, 8, 16, 30)) + np.linspace(0, 3, 16)[None, None, :, None] + offset
    x[0, 0, 0] = np.nan
    x = x if batch else x[1]
    dims = ("member", "lat", "lon", "time") if batch else ("lat", "lon", "time")
    return tuple(
        mod.DataArray(x.astype(dtype), dims, {"time": mod.date_range("2000-01-01", periods=30, freq="D", calendar="noleap")}, {"units": "K"}, "tas")
        for mod in (xt, xp)
    )


@pytest.mark.parametrize("dtype,rtol", [(np.float64, F64), (np.float32, F32)])
@pytest.mark.parametrize("kw", [{}, dict(wavelength_range=["100 km", "400 km"], delta="25 km")])
def test_spectral_variance_matches_reference(dtype, rtol, kw):
    jda, tda = _field(dtype, batch=False)
    got, want = tp.spectral_variance(tda, **kw), jp.spectral_variance(jda, **kw)
    assert got.dims == want.dims == ("time",) and got.attrs["units"] == "(K)2"
    _close(_np(got), _np(want), rtol)


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-10), (np.float32, 5e-4)])
@pytest.mark.parametrize("kw", [{}, dict(dims=["lat", "lon"]), dict(kind="*", thresh="280 K")])
def test_first_eof_matches_reference(dtype, atol, kw):
    """A unit-norm pattern from an eigensolver: held absolutely (f64 1e-10,
    f32 5e-4), with the variance fraction."""
    jda, tda = _field(dtype, batch="thresh" not in kw, offset=280.0 if "thresh" in kw else 0.0)
    got, want = tp.first_eof(tda, **kw), jp.first_eof(jda, **kw)
    assert got.dims == want.dims
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol, equal_nan=True)
    if "variance_fraction" in want.attrs:
        assert got.attrs["variance_fraction"] == pytest.approx(want.attrs["variance_fraction"], abs=atol)


@pytest.mark.parametrize("L", [7, 365])
def test_run_lengths_equal_reference(L):
    from xsdba_tpu.properties import _run_lengths as ref_run_lengths

    rng = np.random.default_rng(L)
    cond = rng.random((3, 4, L)) < 0.55
    cond[0, 0] = True
    cond[0, 1] = False
    cond[1, 0, ::2] = True
    cond[1, 0, 1::2] = False
    np.testing.assert_array_equal(tp._run_lengths(torch.from_numpy(cond)).numpy(), np.asarray(ref_run_lengths(cond)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nan_aware_helpers_match_jnp(dtype):
    """``jnp.nanargmax`` / ``nanargmin`` (NaN skipped, first index of ties,
    -1 on all-NaN rows) and ``jnp.nanquantile`` (computed in float64 in
    64-bit mode, XLA's contraction included, and rounded to x's dtype)."""
    import jax.numpy as jnp

    x = np.round(np.random.default_rng(1).normal(size=(5, 40)), 1).astype(dtype)
    x[0, :10] = np.nan
    x[1] = np.nan
    x[2, 5] = x[2, 30] = 9.0
    x[2, 7] = x[2, 33] = -9.0
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tp._nanargmax(t).numpy(), np.asarray(jnp.nanargmax(x, axis=-1)))
    np.testing.assert_array_equal(tp._nanargmin(t).numpy(), np.asarray(jnp.nanargmin(x, axis=-1)))
    for q in (0.0, 0.1, 0.5, 0.83, 1.0):
        want = np.asarray(jnp.nanquantile(x, q, axis=-1, keepdims=True))
        np.testing.assert_array_equal(tp._nanquantile(t, q).numpy(), want)


def test_every_property_is_exported():
    """All 28 instances, with the reference's contract (ROADMAP C6)."""
    names = [n for n in tp.__all__ if isinstance(getattr(tp, n), tp.StatisticalProperty)]
    assert len(names) == 28 and sorted(names) == sorted(n for n in jp.__all__ if n != "StatisticalProperty")
    for n in names:
        p, r = getattr(tp, n), getattr(jp, n)
        assert (p.identifier, p.aspect, p.allowed_groups, p.measure) == (r.identifier, r.aspect, r.allowed_groups, r.measure)
        assert p.get_measure().identifier == r.get_measure().identifier
    assert xp.properties is tp and "properties" in xp.__all__


def test_acf_default_group_and_attrs():
    _, tda = _das(TAS, "K")
    out = tp.acf(tda)
    assert out.dims == ("site", "season") and out.attrs["long_name"] == "acf" and out.attrs["aspect"] == "temporal"


@pytest.mark.parametrize("call,match", [
    (lambda d: tp.acf(d, group="time"), "not allowed"),
    (lambda d: tp.annual_cycle_phase(d, group="time.month"), "not allowed"),
    (lambda d: tp.return_value(d, group="time.season"), "not allowed"),
    (lambda d: tp.spell_length_distribution(d, group="time.dayofyear"), "not allowed"),
    (lambda d: tp.spell_length_distribution(d, stat="median"), "Unknown stat"),
    (lambda d: tp.spell_length_distribution(d, method="ratio"), "Unknown method"),
    (lambda d: tp.threshold_count(d, stat="mode"), "Unknown stat"),
    (lambda d: tp.return_value(d, method="LM"), "fitting method"),
    (lambda d: tp.corr_btw_var(d, d, corr_type="Kendall"), "Spearman or Pearson"),
    (lambda d: tp.corr_btw_var(d, d, output="zvalue"), "output"),
    (lambda d: tp.trend(d, output="tvalue"), "linregress field"),
    (lambda d: tp._annual_cycle(d, stat="median"), "Unknown stat"),
    (lambda d: tp._annual_statistic(d, stat="median"), "Unknown stat"),
])
def test_bad_arguments_raise(call, match):
    _, tda = _das(PR, "mm/d")
    with pytest.raises(ValueError, match=match):
        call(tda)


@pytest.mark.parametrize("calendar,n", [("noleap", 365 * 7 + 40), ("standard", 3000), ("360_day", 1000)])
@pytest.mark.parametrize("prop", ["group", "month", "season", "time"])
def test_period_blocks_equal_reference(calendar, n, prop):
    """The resample periods every temporal property gathers (vectorized in
    the port and cached on the time index) equal the reference's."""
    from xsdba_tpu.utils.grouper import period_blocks as ref_blocks
    from xsdba_tpu_torch.utils.grouper import period_blocks

    t = xp.date_range("1950-01-03", periods=n, freq="D", calendar=calendar)
    got = period_blocks(t, prop)
    want = ref_blocks(xt.date_range("1950-01-03", periods=n, freq="D", calendar=calendar), prop)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert period_blocks(t, prop) is got
