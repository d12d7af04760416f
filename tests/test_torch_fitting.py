"""The port's GEV fits, regularized incomplete beta, batched linear
regression and host-side scipy fitting against the JAX package, on the CPU.

The same seeded numpy inputs go through both packages.

Tolerances.  ``gev_ppf`` and ``_gev_nll`` hold 1e-12 relative in float64
(the two libraries' ``pow``, ``exp`` and ``lgamma`` differ by an ulp now
and then) and 2e-6 in float32; ``_gev_skew`` holds 1e-12 relative (its
absolute part scaled by the largest value) plus its formula's
cancellation, 1e-14 / |c|^3.  The closed-form
gradient and Hessian of the GEV likelihood hold 1e-10 relative to
``jax.grad`` / ``jax.hessian`` of the reference's likelihood.  The fits:
the PWM fit is closed-form and holds 1e-11 relative in float64 (its
L-moment ratio cancels); the MM fit's 80 bisection steps hold 1e-9; the ML
fit's last Newton steps follow rounding noise near a flat optimum, so
float64 fits hold 1e-6 relative and the likelihood they reach 1e-12
(ROADMAP C20).  In float32 the fits are held to the reference's float64
fit of the same float32 values (the reference's ``gev_fit_ml`` raises on
float32 input in 64-bit mode, C20): PWM and MM parameters within 1e-4
absolute, ML return values within 1e-3 relative.  ``betainc`` holds
scipy's and the reference's values within 1e-12 (absolute plus relative)
in float64; in float32 both packages' continued fractions are ~1e-4 from
scipy (the log-beta factor's rounding), and the port is held within 5e-5
absolute of scipy and 2e-4 of the reference.  ``linregress_field`` holds
1e-12 relative in float64 (the absolute part scaled by the field's
largest value), and in float32 2e-6 relative against the reference's
float64 regression of the same values for slope, intercept and rvalue,
5e-5 absolute for the p-value.  The host fitting (``fit_scipy``, the
L-moments) is the same numpy and scipy code in both packages and equals
the reference exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special, stats

from xsdba_tpu.ops import fitting as jf
from xsdba_tpu_torch.ops import fitting as tf

F64 = 1e-12


def _t(a, dtype=np.float64):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _close(got, want, rtol, scale=True):
    """|got - want| <= rtol |want| + rtol max|want| (NaN where want is NaN)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    atol = rtol * np.nanmax(np.abs(want)) if scale and np.isfinite(want).any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


def _gev_rows(n=16, N=60, seed=1):
    """GEV samples [n, N] with NaN gaps, an all-NaN row and a row of 2 values."""
    x = stats.genextreme.rvs(0.12, loc=30, scale=3, size=(n, N), random_state=seed)
    rng = np.random.default_rng(seed)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[3] = np.nan
    x[4, 2:] = np.nan
    return x


# ----------------------------------------------------------------- GEV pieces


@pytest.mark.parametrize("dtype,rtol", [(np.float64, F64), (np.float32, 2e-6)])
def test_gev_ppf_matches_reference(dtype, rtol):
    rng = np.random.default_rng(0)
    c = np.concatenate([rng.uniform(-0.4, 0.4, 20), [0.0, 1e-13, -1e-13]]).astype(dtype)
    loc, scale = rng.normal(30, 3, c.shape).astype(dtype), rng.uniform(1, 4, c.shape).astype(dtype)
    for q in (0.95, 0.05, 0.5):
        want = np.asarray(jf.gev_ppf(q, c, loc, scale))
        _close(tf.gev_ppf(q, _t(c, dtype), _t(loc, dtype), _t(scale, dtype)).numpy(), want, rtol)


def test_gev_nll_and_skew_match_reference():
    x = _gev_rows(6, 50)
    valid = ~np.isnan(x)
    params = np.array([[0.1, 29.0, 1.1], [-0.2, 31.0, 0.9], [1e-10, 30.0, 1.0], [0.6, 28.0, 0.5], [0.3, 40.0, 1.2]])
    for p in params:
        want = [float(jf._gev_nll(jnp.asarray(p), jnp.asarray(row), jnp.asarray(v))) for row, v in zip(x, valid)]
        got = tf._gev_nll(_t(p)[None].expand(len(x), 3), _t(x), torch.from_numpy(valid))
        _close(got.numpy(), want, F64)
    # the third central moment cancels as c^3 near c = 0 (the formula's own
    # conditioning, in both packages): 1e-12 relative plus 1e-14 / |c|^3
    c = np.linspace(-0.33, 3.0, 97)
    want = np.asarray(jf._gev_skew(jnp.asarray(c)))
    bound = (F64 + 1e-14 / np.abs(c) ** 3) * np.abs(want) + F64 * np.abs(want).max()
    assert (np.abs(tf._gev_skew(_t(c)).numpy() - want) <= bound).all()


def test_gev_derivatives_match_autodiff():
    """The closed-form gradient and Hessian against ``jax.grad`` and
    ``jax.hessian`` of the reference's likelihood, in both branches (Gumbel
    at |c| < 1e-9) and with the support's barrier active (c = 0.6)."""
    x = _gev_rows(5, 50)
    valid = ~np.isnan(x)
    for p in ([0.1, 29.0, 1.1], [-0.2, 31.0, 0.9], [1e-10, 30.0, 1.0], [0.6, 28.0, 0.5]):
        pt = _t([p] * len(x))
        g, h = tf._gev_nll_derivatives(pt, _t(x), torch.from_numpy(valid), tf._gev_nll(pt, _t(x), torch.from_numpy(valid)))
        for i, (row, v) in enumerate(zip(x, valid)):
            if not v.any():
                continue
            f = lambda q: jf._gev_nll(q, jnp.asarray(row), jnp.asarray(v))  # noqa: E731
            _close(g[i].numpy(), np.asarray(jax.grad(f)(jnp.asarray(p))), 1e-10)
            _close(h[i].numpy(), np.asarray(jax.hessian(f)(jnp.asarray(p))), 1e-10)


# ----------------------------------------------------------------- GEV fits


@pytest.mark.parametrize("name,rtol", [("gev_fit_pwm", 1e-11), ("gev_fit_mm", 1e-9)])
def test_closed_form_fits_match_reference_f64(name, rtol):
    x = _gev_rows()
    want = getattr(jf, name)(x)
    got = getattr(tf, name)(_t(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        _close(g.numpy(), np.asarray(w), rtol)
    assert np.isnan(got[0].numpy()[[3, 4]]).all() and np.isfinite(got[0].numpy()[[0, 1, 2, 5]]).all()


def test_ml_fit_matches_reference_f64():
    """float64 ML fits agree to 1e-6 and reach the same likelihood to 1e-12
    (ROADMAP C20); rows with fewer than 3 values are NaN."""
    x = _gev_rows()
    want = [np.asarray(a) for a in jf.gev_fit_ml(x)]
    got = [a.numpy() for a in tf.gev_fit_ml(_t(x))]
    for g, w in zip(got, want):
        _close(g, w, 1e-6, scale=False)
    assert np.isnan(got[0][[3, 4]]).all()
    for i, row in enumerate(x):
        r = row[~np.isnan(row)]
        if len(r) < 3:
            continue
        nll = [-stats.genextreme.logpdf(r, *(p[i] for p in ps)).sum() for ps in (got, want)]
        assert nll[0] == pytest.approx(nll[1], rel=1e-12)


@pytest.mark.parametrize("name,tol", [("gev_fit_pwm", 1e-4), ("gev_fit_mm", 1e-4), ("gev_fit_ml", 1e-3)])
def test_fits_float32_against_reference_f64(name, tol):
    """float32 fits against the reference's float64 fit of the same float32
    values: PWM and MM parameters within 1e-4, ML return values within 1e-3
    relative (the likelihood's float32 rounding near its flat optimum)."""
    x = stats.genextreme.rvs(0.12, loc=30, scale=3, size=(64, 150), random_state=1).astype(np.float32)
    want = [np.asarray(a) for a in getattr(jf, name)(x.astype(np.float64))]
    got = [a.numpy().astype(np.float64) for a in getattr(tf, name)(_t(x, np.float32))]
    assert getattr(tf, name)(_t(x[:2], np.float32))[0].dtype == torch.float32
    if name == "gev_fit_ml":
        rv = lambda p: np.asarray(jf.gev_ppf(0.95, *p))  # noqa: E731
        np.testing.assert_allclose(rv(got), rv(want), rtol=tol)
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def test_fits_nan_below_three_samples_and_all_nan():
    X = np.full((3, 50), np.nan)
    X[1, :2] = [1.0, 2.0]
    X[2, :10] = np.linspace(1, 5, 10)
    for fit in (tf.gev_fit_pwm, tf.gev_fit_ml, tf.gev_fit_mm):
        c, loc, scale = (a.numpy() for a in fit(_t(X)))
        assert np.isnan([c[:2], loc[:2], scale[:2]]).all(), fit.__name__
        assert np.isfinite([c[2], loc[2], scale[2]]).all(), fit.__name__


def test_ml_fit_batch_shape_and_quality():
    """Leading batch dims are kept, and each fit's likelihood is at least
    scipy's ``genextreme.fit`` (the reference's own contract)."""
    X = stats.genextreme.rvs(0.12, loc=30, scale=3, size=(2, 4, 60), random_state=1)
    c, loc, scale = tf.gev_fit_ml(_t(X))
    assert c.shape == (2, 4)
    for i, row in enumerate(X.reshape(8, 60)):
        ours = -stats.genextreme.logpdf(row, float(c.reshape(-1)[i]), float(loc.reshape(-1)[i]), float(scale.reshape(-1)[i])).sum()
        assert ours <= -stats.genextreme.logpdf(row, *stats.genextreme.fit(row)).sum() + 1e-3


# ----------------------------------------------------------------- betainc


def _beta_grid(dtype):
    df = np.arange(1, 301, dtype=dtype)[:, None]
    x = np.linspace(0.001, 0.999, 97, dtype=dtype)[None, :]
    return np.broadcast_to(df / 2, (300, 97)), np.full((300, 97), 0.5, dtype), np.broadcast_to(x, (300, 97))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_betainc_grid_matches_scipy_and_reference(dtype):
    a, b, x = _beta_grid(dtype)
    got = tf.betainc(_t(a, dtype), _t(b, dtype), _t(x, dtype)).numpy().astype(np.float64)
    sc = special.betainc(a.astype(np.float64), b.astype(np.float64), x.astype(np.float64))
    ref = np.asarray(jax.scipy.special.betainc(a, b, x)).astype(np.float64)
    if dtype == np.float64:
        np.testing.assert_allclose(got, sc, rtol=F64, atol=F64)
        np.testing.assert_allclose(got, ref, rtol=F64, atol=F64)
    else:
        np.testing.assert_allclose(got, sc, rtol=0, atol=5e-5)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_betainc_special_values():
    a = _t([0.0, 1.0, 2.0, -1.0, 2.0, np.nan, 3.0, 3.0, 0.5])
    b = _t([1.0, 0.0, 2.0, 1.0, 2.0, 1.0, 2.0, 2.0, 0.5])
    x = _t([0.3, 0.3, 0.0, 0.5, 1.5, 0.5, 1.0, 0.25, 0.9])
    got = tf.betainc(a, b, x).numpy()
    want = np.asarray(jax.scipy.special.betainc(np.asarray(a), np.asarray(b), np.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=F64, atol=F64, equal_nan=True)


# ----------------------------------------------------------------- linregress


@pytest.mark.parametrize("field", ["slope", "intercept", "rvalue", "pvalue", "stderr", "intercept_stderr"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_linregress_field_matches_reference(field, dtype):
    rng = np.random.default_rng(42)
    P = 24
    Y = rng.normal(0, 1, (20, P)) + 0.2 * np.arange(P)
    Y[rng.random(Y.shape) < 0.2] = np.nan
    Y[0, 2:] = np.nan                     # fewer than 3 points
    Y[1] = 5.0                            # no variance in y
    Y = Y.astype(dtype)
    x = np.arange(P, dtype=dtype)
    got = tf.linregress_field(_t(Y, dtype), _t(x, dtype), field)
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    if dtype == np.float64:
        _close(got.numpy(), np.asarray(jf.linregress_field(Y, x, field)), F64)
        for i, row in enumerate(Y):
            m = ~np.isnan(row)
            if m.sum() >= 3 and np.ptp(row[m]) > 0:
                res = stats.linregress(x[m], row[m])
                want = res.intercept_stderr if field == "intercept_stderr" else getattr(res, field)
                assert got[i].item() == pytest.approx(want, abs=1e-10)
    else:
        want = np.asarray(jf.linregress_field(Y.astype(np.float64), x.astype(np.float64), field))
        if field == "pvalue":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5, equal_nan=True)
        else:
            _close(got.numpy(), want, 2e-6)


def test_linregress_constant_x_and_bad_field():
    y = _t(np.arange(10.0)[None])
    assert torch.isnan(tf.linregress_field(y, torch.ones(10, dtype=torch.float64), "slope")).all()
    with pytest.raises(ValueError, match="linregress field"):
        tf.linregress_field(y, torch.arange(10.0, dtype=torch.float64), "tvalue")


# ----------------------------------------------------------------- host fitting

PWM_CASES = [
    ("expon", (2.0, 3.0)), ("gumbel_r", (10.0, 2.5)), ("genpareto", (0.15, 1.0, 2.0)), ("genpareto", (-0.2, 0.0, 1.5)),
    ("gamma", (3.0, 0.0, 2.0)), ("gamma", (0.7, 0.0, 1.0)), ("genextreme", (0.12, 8.0, 2.0)), ("genextreme", (-0.15, 0.0, 1.0)),
    ("pearson3", (0.8, 5.0, 2.0)), ("pearson3", (-0.5, 0.0, 1.0)), ("weibull_min", (1.7, 0.0, 3.0)), ("weibull_min", (0.9, 2.0, 1.0)),
]
OTHER_CASES = [
    ("genextreme", (0.1, 30.0, 3.0), "ML", {}), ("gamma", (3.0, 0.0, 2.0), "ML", {"floc": 0.0}), ("genextreme", (0.1, 30.0, 3.0), "APP", {}),
    ("fisk", (8.0, 1.0, 2.0), "APP", {"floc": 1.0}), ("fisk", (8.0, 1.0, 2.0), "APP", {}), ("weibull_min", (2.0, 5.0, 3.0), "APP", {}),
    ("gamma", (3.0, 0.0, 2.0), "APP", {}), ("genpareto", (0.1, 0.0, 2.0), "APP", {"floc": 0.0}), ("norm", (1.0, 2.0), "MM", {}),
]


@pytest.mark.parametrize("name,true,method,kw", [(n, t, "PWM", {}) for n, t in PWM_CASES] + OTHER_CASES)
def test_fit_scipy_equals_reference(name, true, method, kw):
    x = getattr(stats, name).rvs(*true, size=400, random_state=np.random.default_rng(hash(name) % 2**32))
    x[::37] = np.nan
    got = tf.fit_scipy(_t(x), name, method=method, **kw)
    np.testing.assert_array_equal(got, jf.fit_scipy(x, name, method=method, **kw))
    assert tf.sample_lmoments(x[~np.isnan(x)]) == jf.sample_lmoments(x[~np.isnan(x)])


def test_fit_scipy_errors_and_degenerate():
    x = np.random.default_rng(0).lognormal(size=100)
    with pytest.raises(NotImplementedError, match="lognorm"):
        tf.fit_scipy(x, "lognorm", method="PWM")
    with pytest.raises(ValueError, match="APP"):
        tf.fit_scipy(x, "lognorm", method="APP")
    with pytest.raises(ValueError, match="fitting method"):
        tf.fit_scipy(x, "gamma", method="XX")
    assert np.isnan(tf.fit_scipy(np.zeros(50), "genpareto", method="PWM")).all()
    assert np.isnan(tf.fit_scipy(np.array([1.0]), "gamma", method="PWM")).all()
    assert tf.PWM_SUPPORTED == jf.PWM_SUPPORTED
