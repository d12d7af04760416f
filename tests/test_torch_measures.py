"""The port's statistical measures against the JAX package, on the CPU, and
BASELINE config 5 (QDM adjust plus the validation suite) end to end at a
small size.

The same seeded numpy inputs go through both packages.

Tolerances.  The elementwise measures (bias, relative bias, circular bias,
ratio) equal the reference under ``==``.  The reductions (RMSE, MAE, the
annual-cycle correlation, the Taylor diagram, Scorr) differ by the two
libraries' summation orders: float64 holds 1e-12 relative, float32 2e-6,
each with an absolute part of the same size times the result's largest
magnitude.  Config 5 (``chip_smoke.py``'s recipe and pipeline at 8 sites
× 10 noleap years of tas and pr: QDM train and adjust, monthly, nq = 50, pr
multiplicative with the jitter, the reference's draws substituted): ``scen`` equals the reference under ``==``
(as every public QDM ``scen`` does), and each property and measure of the
suite is then held as ``test_torch_properties.py`` holds it, in float32
(config 5's dtype): the quantiles, frequencies and phases exactly, the
moments and spell means at 2e-6, the annual-cycle amplitude (the
difference of two climatology values near 290 K) at 2e-6 of the data's
magnitude, the trend at the slope that errors of 2e-6 of the data in each
yearly mean would give (2e-6 |x| sqrt(12 / (n (n^2 - 1))), n years), each
bias at the tolerance of the properties it subtracts times their
magnitude (the relative and circular biases at 2e-6), and the correlation and return value (ML, where the reference's
float32 fit raises in 64-bit mode, ROADMAP C20) against the reference's
float64 result of the same float32 values, the correlation at 1e-4 and the
return value at 1e-3 relative (the bias of two return values at 1e-2 of
the larger).
"""

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu import measures as jm
from xsdba_tpu import properties as jp
from xsdba_tpu_torch import measures as tm
from xsdba_tpu_torch import properties as tp

F64, F32 = 1e-12, 2e-6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


def _np(da):
    return np.asarray(da.data.numpy() if isinstance(da.data, torch.Tensor) else da.data, dtype=np.float64)


def _close(got, want, rtol):
    atol = rtol * np.nanmax(np.abs(want)) if np.isfinite(want).any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


def _pair(x, dims, units, coords=None):
    """The same data as a DataArray of each package."""
    return tuple(mod.DataArray(x, dims, dict(coords or {}), {"units": units}, "v") for mod in (xt, xp))


def _series(dtype, T=365 * 4, S=3, seed=0):
    rng = np.random.default_rng(seed)
    base = 10 + 8 * np.sin(2 * np.pi * np.arange(T) / 365)[None] + rng.normal(0, 2, (S, T))
    other = base + rng.normal(0.5, 1.5, (S, T))
    base[1, 30:60] = np.nan
    t = {mod: mod.date_range("2000-01-01", periods=T, freq="D", calendar="noleap") for mod in (xt, xp)}
    mk = lambda x, u: tuple(mod.DataArray(x.astype(dtype), ("site", "time"), {"time": t[mod]}, {"units": u}, "tas") for mod in (xt, xp))  # noqa: E731
    return mk(other, "degC"), mk(base, "degC")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["bias", "relative_bias", "circular_bias", "ratio"])
def test_elementwise_measures_equal_reference(dtype, name):
    rng = np.random.default_rng(1)
    sim, ref = (rng.uniform(1, 365, (4, 6)).astype(dtype) for _ in range(2))
    ref[0, 0] = np.nan
    coords = {"site": np.arange(4)}
    (js, ts), (jr, tr) = _pair(sim, ("site", "month"), "d", coords), _pair(ref, ("site", "month"), "d", coords)
    got, want = getattr(tm, name)(ts, tr), getattr(jm, name)(js, jr)
    assert got.dims == want.dims and got.attrs == want.attrs and got.data.dtype == torch.from_numpy(sim).dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want.data, dtype=np.float64))


@pytest.mark.parametrize("dtype,rtol", [(np.float64, F64), (np.float32, F32)])
@pytest.mark.parametrize("name,kw", [
    ("rmse", {}), ("mae", {}), ("annual_cycle_correlation", {}), ("annual_cycle_correlation", {"window": 31}),
    ("taylordiagram", {}), ("taylordiagram", {"normalize": True}),
])
def test_reducing_measures_match_reference(dtype, rtol, name, kw):
    (js, ts), (jr, tr) = _series(dtype)
    got, want = getattr(tm, name)(ts, tr, **kw), getattr(jm, name)(js, jr, **kw)
    assert got.dims == want.dims and got.attrs == want.attrs
    _close(_np(got), np.asarray(want.data, dtype=np.float64), rtol)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, F64), (np.float32, F32)])
def test_scorr_matches_reference(dtype, rtol):
    rng = np.random.default_rng(2)
    n, T = 10, 300
    base = rng.normal(size=T)
    coords = {"lon": rng.uniform(0, 3, n), "lat": rng.uniform(40, 43, n)}
    sim = (base[None] * rng.uniform(0.2, 1, (n, 1)) + rng.normal(0, 1, (n, T))).astype(dtype)
    ref = (base[None] * rng.uniform(0.2, 1, (n, 1)) + rng.normal(0, 1, (n, T))).astype(dtype)
    t = {mod: mod.date_range("2000-01-01", periods=T, freq="D", calendar="noleap") for mod in (xt, xp)}
    das = {mod: [mod.DataArray(x, ("site", "time"), {"time": t[mod], **coords}, {"units": "K"}, "tas") for x in (sim, ref)] for mod in (xt, xp)}
    got, want = tm.scorr(*das[xp]), jm.scorr(*das[xt])
    assert got.dims == () and got.attrs == want.attrs
    _close(_np(got), np.asarray(want.data, dtype=np.float64), rtol)


def test_units_are_converted_and_checked():
    """sim in degC against ref in K: converted to ref's units first."""
    (js, ts), (jr, tr) = _series(np.float64)
    for d in (jr, tr):
        d.data = d.data + 273.15
        d.attrs["units"] = "K"
    for name in ("bias", "rmse"):
        got, want = getattr(tm, name)(ts, tr), getattr(jm, name)(js, jr)
        assert got.attrs["units"] == want.attrs["units"] == "K"
        _close(_np(got), np.asarray(want.data, dtype=np.float64), F64)


@pytest.mark.parametrize("call,err,match", [
    (lambda s, r: tm.rmse(s, r, group="time.month"), ValueError, "not allowed"),
    (lambda s, r: tm.scorr(s, r, group="time.season"), ValueError, "not allowed"),
    (lambda s, r: tm.bias(s.data, r), TypeError, "DataArray"),
    (lambda s, r: tm.bias(xp.DataArray(s.data[:, :100], s.dims, {"time": s.time.isel(slice(0, 100))}, s.attrs), r), ValueError, "different coordinates"),
    (lambda s, r: tm.mae(s, xp.DataArray(r.data, r.dims, {"time": xp.date_range("2001-01-01", periods=r.shape[-1], freq="D", calendar="noleap")}, r.attrs)), ValueError, "different coordinates"),
])
def test_bad_inputs_raise(call, err, match):
    (_, ts), (_, tr) = _series(np.float64)
    with pytest.raises(err, match=match):
        call(ts, tr)


def test_every_measure_is_exported():
    for name in jm.__all__:
        ours, theirs = getattr(tm, name), getattr(jm, name)
        if isinstance(theirs, type):
            continue
        assert type(ours).__name__ == type(theirs).__name__ and ours.identifier == theirs.identifier
        assert getattr(ours, "allowed_groups", None) == getattr(theirs, "allowed_groups", None)
    assert sorted(tm.__all__) == sorted(jm.__all__) and xp.measures is tm


# ------------------------------------------------------------ BASELINE config 5

EXACT = ("q98", "phase", "wet freq", "wet-wet")
VS_F64 = {"corr": 1e-4}


def test_config5_end_to_end_matches_reference(monkeypatch):
    """``chip_smoke.py``'s config 5 pipeline at 8 sites x 10 years: QDM
    train + adjust of tas (additive) and pr (multiplicative, the jitter),
    then the suite on ref, sim and scen and the measures of scen against
    ref, held to the reference."""
    from chip_smoke import config5_block, config5_qdm, config5_return_values, config5_suite
    from e2e_cases import JAX_SEED
    from test_torch_qdm import reference_draws
    from xsdba_tpu.utils.rng import seed as jax_seed

    reference_draws(monkeypatch)
    _, tas_np, pr_np = config5_block(0, 8, 10)
    runs = {}
    for mod in (xt, xp):
        jax_seed(JAX_SEED)
        t = mod.date_range("1950-01-01", periods=tas_np[0].shape[-1], freq="D", calendar="noleap")
        runs[mod] = config5_qdm(mod, t, tas_np, pr_np)
    for v in (0, 1):
        np.testing.assert_array_equal(_np(runs[xp][v]["scen"]), np.asarray(runs[xt][v]["scen"].data, dtype=np.float64))
    got = config5_suite(tp, tm, *runs[xp])
    want = config5_suite(jp, jm, *runs[xt])
    as64 = [{k: xt.DataArray(np.asarray(d.data, dtype=np.float64), d.dims, d.coords, d.attrs, d.name) for k, d in v.items()} for v in runs[xt]]
    want64 = config5_suite(jp, jm, *as64)
    assert got.keys() == want.keys()
    n = tas_np[0].shape[-1] // 365
    for key, g in got.items():
        assert g.dims == want[key].dims, key
        kind = key.split(" ", 1)[-1]
        ref = (want64 if kind in VS_F64 else want)[key]
        tol = VS_F64.get(kind, F32)
        # a bias is held at the tolerance of the properties it subtracts, times their magnitude;
        # the amplitude (max - min of climatologies) at 2e-6 of the data's, and the trend at the
        # slope that errors of 2e-6 of the data in each yearly mean would give
        scale = {"amplitude": 1.0, "trend": np.sqrt(12 / (n * (n * n - 1)))}.get(kind)
        if scale is not None:
            scale *= np.abs(tas_np[0]).max()
        elif key.startswith("bias"):
            scale = np.nanmax(np.abs(_np(want[f"ref {kind}"])))
        elif "_bias" in key:  # relative or circular: of order 1
            scale = 1.0
        if scale is not None:
            np.testing.assert_allclose(_np(g), _np(ref), rtol=0, atol=tol * scale, err_msg=key)
        elif kind in EXACT:
            np.testing.assert_array_equal(_np(g), np.asarray(want[key].data).astype(np.float32).astype(np.float64), err_msg=key)
        else:
            _close(_np(g), _np(ref), tol)
    # the 20-year return value (ML): the reference's float32 fit raises (C20), so its float64 fit of the same values
    rv, rv64 = config5_return_values(tp, tm, runs[xp][0]), config5_return_values(jp, jm, as64[0])
    for k in ("ref", "sim", "scen"):
        np.testing.assert_allclose(_np(rv[f"{k} rv20"]), _np(rv64[f"{k} rv20"]), rtol=1e-3)
    _close(_np(rv["bias rv20"]), _np(rv64["bias rv20"]), 1e-2)
