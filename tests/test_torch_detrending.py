"""The port's detrending family against the JAX package, on the CPU.

``ops/detrend.py`` (polynomial trends by masked normal equations),
``ops/loess.py`` (both LOESS cores) and the detrending objects of
``detrending.py`` run on the same numpy inputs through both packages.

Tolerances: float64 at 1e-12 (relative; 1e-12 absolute for the detrended
series), float32 at 2e-6.  A degree-4 fit in float32 is held at 2e-5: its
normal equations (a Gram matrix of condition ~1e3 on [-1, 1]) carry the
rounding of sums that XLA and PyTorch add in different orders.  LOESS with
``d=1`` sums powers of the uncentred coordinate, as the JAX package does,
so its weighted sums cancel: it is held on ``x = arange(n)`` at 1e-12 in
float64 and 1e-4 in float32, where an ulp of the sums moves the local
slope.
"""

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu.ops.detrend import grouped_polyfit_trend as j_grouped_polyfit
from xsdba_tpu.ops.detrend import polyfit_trend as j_polyfit
from xsdba_tpu.ops.loess import loess_smoothing as j_loess
from xsdba_tpu_torch.ops.detrend import grouped_polyfit_trend, polyfit_trend
from xsdba_tpu_torch.ops.loess import _nanmedian, loess_smoothing


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


TOL = {np.float64: dict(rtol=1e-12, atol=1e-12, equal_nan=True), np.float32: dict(rtol=2e-6, atol=2e-6, equal_nan=True)}
POLY_F32 = {1: TOL[np.float32], 4: dict(rtol=2e-5, atol=2e-5, equal_nan=True)}
T = 365 * 3


def _series(seed, shape, dtype, nan=True):
    """Gamma-distributed data with a trend and a seasonal cycle; with
    ``nan`` a few missing values and, in the last row, a missing month."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    t = np.arange(n)
    x = rng.gamma(2.0, 2.0, shape) * (1 + 0.3 * t / n) * (1 + 0.3 * np.sin(2 * np.pi * t / 365)) + 0.5
    if nan:
        x.reshape(-1, n)[0, rng.choice(n, 7, replace=False)] = np.nan
        x.reshape(-1, n)[-1, 31:59] = np.nan
    return x.astype(dtype)


# ----------------------------------------------------------------- polyfit


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("degree", [1, 4])
def test_polyfit_trend(dtype, degree):
    """Rows with NaNs, an all-NaN row (its trend is NaN) and ordinal x."""
    y = _series(1, (3, T), dtype)
    y[1] = np.nan
    x = np.arange(T, dtype=np.float64) + 723_180.0
    want = np.asarray(j_polyfit(y, x, degree=degree))
    got = polyfit_trend(torch.from_numpy(y), x, degree=degree)
    assert got.dtype == torch.from_numpy(y).dtype
    assert np.isnan(got[1].numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **(TOL[dtype] if dtype == np.float64 else POLY_F32[degree]))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("degree", [1, 4])
def test_grouped_polyfit_trend(dtype, degree):
    """Monthly groups over ten years, one of them all NaN in a row (every
    February missing: its trend is NaN)."""
    n = 365 * 10
    y = _series(2, (2, n), dtype)
    t = xt.date_range("1991-01-01", periods=n, freq="D", calendar="noleap")
    y[1, t.month == 2] = np.nan
    gi = xt.Grouper("time.month").indexes(t)
    x = np.asarray(t.ordinal, dtype=np.float64)
    want = np.asarray(j_grouped_polyfit(y, x, gi.gather_idx, gi.group_idx, gi.scatter_slot, degree=degree))
    got = grouped_polyfit_trend(torch.from_numpy(y), x, gi.gather_idx, gi.group_idx, gi.scatter_slot, degree=degree)
    assert np.isnan(got[1, t.month == 2].numpy()).all() and not np.isnan(got[1, t.month != 2].numpy()).any()
    np.testing.assert_allclose(got.numpy(), want, **(TOL[dtype] if dtype == np.float64 else POLY_F32[degree]))


# ------------------------------------------------------------------- LOESS


def test_nanmedian_averages_the_middle_values():
    """``jnp.nanmedian`` averages the two middle values; ``torch.nanmedian``
    takes the lower one.  The port follows the JAX package."""
    import jax.numpy as jnp

    a = np.array([[1.0, 2.0, 3.0, 4.0], [np.nan, 5.0, 1.0, np.nan], [np.nan] * 4, [3.0, np.nan, 1.0, 2.0]])
    want = np.asarray(jnp.nanmedian(a, axis=-1, keepdims=True))
    got = _nanmedian(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 2.5 and float(torch.nanmedian(torch.from_numpy(a[0]))) == 2.0


LOESS_F32 = {0: dict(rtol=2e-6, atol=2e-6, equal_nan=True), 1: dict(rtol=1e-4, atol=1e-4, equal_nan=True)}


@pytest.mark.parametrize("n", [200, 5000], ids=["gather", "fft"])
@pytest.mark.parametrize("d", [0, 1])
@pytest.mark.parametrize("weights,niter", [("tricube", 1), ("tricube", 2), ("gaussian", 2)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_loess_smoothing(n, d, weights, niter, dtype):
    """Both cores (the gathered windows at n = 200, the FFT interior with the
    edges as matrix products at n = 5000), both degrees, both weights, one
    and two robustness iterations (the median of an even count), NaNs."""
    y = _series(3, (2, n), dtype)
    x = np.arange(n, dtype=np.float64) + (723_180.0 if d == 0 else 0.0)
    want = np.asarray(j_loess(y, x, f=0.2, niter=niter, d=d, weights=weights))
    got = loess_smoothing(torch.from_numpy(y), x, f=0.2, niter=niter, d=d, weights=weights).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **(TOL[dtype] if dtype == np.float64 else LOESS_F32[d]))


def test_loess_fft_edges_and_interior():
    """At a window of more than 512 values the FFT core recomputes
    ``hw + 3`` points a side by the shrinking-bandwidth formula: interior and
    edges both agree, in float64 and float32."""
    n = 6000
    r = 2 * (int(0.2 * n) // 2) + 1
    edge = (r - 1) // 2 + 3
    for dtype in (np.float64, np.float32):
        y = _series(4, (2, n), dtype, nan=False)
        x = np.arange(n, dtype=np.float64) + 723_180.0
        want = np.asarray(j_loess(y, x, f=0.2, niter=1, d=0))
        got = loess_smoothing(torch.from_numpy(y), x, f=0.2, niter=1, d=0).numpy()
        for part in (np.s_[:, :edge], np.s_[:, edge:-edge], np.s_[:, -edge:]):
            np.testing.assert_allclose(got[part], want[part], **TOL[dtype])


def test_loess_refusals():
    y = torch.zeros(10, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        loess_smoothing(y, np.arange(10.0), d=2)
    with pytest.raises(ValueError):
        loess_smoothing(y, np.arange(10.0), weights="box")


# ------------------------------------------------------- detrending objects


def _da(mod, x, start="1991-01-01"):
    t = mod.date_range(start, periods=x.shape[-1], freq="D", calendar="noleap")
    return mod.DataArray(x, ("site", "time"), {"time": t}, {"units": "mm/d"}, "pr")


def _np(da):
    return da.data.numpy() if isinstance(da.data, torch.Tensor) else np.asarray(da.data)


DETRENDS = [
    ("NoDetrend", dict()),
    ("MeanDetrend", dict(group="time.month", kind="*")),
    ("PolyDetrend", dict(degree=2, kind="*")),
    ("PolyDetrend", dict(group="time.month", degree=1, preserve_mean=True)),
    ("PolyDetrend", dict(group="time.season", degree=1, kind="*", mult_skip_zeros=True)),
    ("LoessDetrend", dict(f=0.2, niter=2, d=0, kind="*")),
    ("LoessDetrend", dict(group="time.month", f=0.3, d=1, weights="gaussian")),
    ("RollingMeanDetrend", dict(win=31, min_periods=20)),
    ("RollingMeanDetrend", dict(win=5, weights=[1, 2, 3, 2, 1], kind="*")),
]


@pytest.mark.parametrize("cls,kw", DETRENDS)
def test_detrend_objects_match_reference(cls, kw):
    """fit / detrend / retrend of each class on the same series, f64; the
    multiplicative ``mult_skip_zeros`` case with zeros in the data."""
    x = _series(5, (2, T), np.float64)
    x[0, 100:110] = 0.0
    want = getattr(xt.detrending, cls)(**kw).fit(_da(xt, x))
    got = getattr(xp.detrending, cls)(**kw).fit(_da(xp, torch.from_numpy(x)))
    assert got.fitted and type(got).__name__ == cls
    np.testing.assert_allclose(_np(got.ds["trend"]), _np(want.ds["trend"]), **TOL[np.float64])
    sim = _series(6, (2, T), np.float64)
    d_want = want.detrend(_da(xt, sim, "2051-01-01"))
    d_got = got.detrend(_da(xp, torch.from_numpy(sim), "2051-01-01"))
    np.testing.assert_allclose(_np(d_got), _np(d_want), **TOL[np.float64])
    np.testing.assert_allclose(_np(got.retrend(d_got)), _np(want.retrend(d_want)), **TOL[np.float64])


def test_detrend_unfitted_and_refusals():
    det = xp.detrending.PolyDetrend(degree=1)
    assert not det.fitted and "unfitted" in repr(det)
    with pytest.raises(ValueError, match="fit"):
        det.detrend(_da(xp, torch.zeros(1, 10, dtype=torch.float64)))
    with pytest.raises(NotImplementedError):
        xp.detrending.RollingMeanDetrend(weights=[1, 1], min_periods=1)
    with pytest.warns(UserWarning):
        xp.detrending.LoessDetrend(equal_spacing=False)


@pytest.mark.parametrize("cls,kw", [("PolyDetrend", dict(degree=3, kind="*")), ("LoessDetrend", dict(f=0.3)), ("RollingMeanDetrend", dict(win=9, weights=np.ones(9)))])
def test_fitted_detrend_files_cross_the_packages(tmp_path, cls, kw):
    """A detrend fitted and saved by the JAX package loads in the port and
    detrends alike; the port's file loads back in the JAX package."""
    x = _series(7, (2, T), np.float64)
    fitted = getattr(xt.detrending, cls)(**kw).fit(_da(xt, x))
    sim = _series(8, (2, T), np.float64)
    want = _np(fitted.detrend(_da(xt, sim)))
    path = str(tmp_path / "det")
    fitted.save(path)
    loaded = xp.detrending.BaseDetrend.from_file(path)
    assert type(loaded) is getattr(xp.detrending, cls) and loaded.fitted
    np.testing.assert_allclose(_np(loaded.detrend(_da(xp, torch.from_numpy(sim)))), want, **TOL[np.float64])
    back = str(tmp_path / "back")
    loaded.save(back)
    np.testing.assert_allclose(_np(xt.detrending.BaseDetrend.from_file(back).detrend(_da(xt, sim))), want, **TOL[np.float64])
