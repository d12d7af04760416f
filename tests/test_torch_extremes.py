"""The port's exceedance clusters, Generalized Pareto functions and
``ExtremeValues`` against the JAX package, on the CPU.

The same seeded numpy inputs go through both packages.

Tolerances.  The clusters are integer bookkeeping and equal exactly.  The
GPD CDF and quantile function hold 1e-12 in float64 (the two libraries'
``pow`` and ``log1p`` differ by an ulp now and then).  The ML fit is a
golden-section search whose last decisions compare profile likelihoods that
differ by rounding noise near the flat optimum, so its result is fixed only
to about the square root of the machine epsilon (ROADMAP C18): float64 fits
agree to 1e-6 and reach the same likelihood to 1e-12; float32 fits agree
to 5e-3 in the shape.  The two
``ExtremeValues`` cores hold 1e-10 in float64 given the same fit (a
stand-in fit with no reduction, substituted in both packages), and the
public calls hold 1e-10 on the e2e recipe, whose fits sit at the support's
edge; with interior fits the public ``scen`` holds a relative 1e-6.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from e2e_cases import build_inputs
from xsdba_tpu.models import extremes as jx
from xsdba_tpu.ops import clusters as jc
from xsdba_tpu.ops import fitting as jf
from xsdba_tpu_torch.models import extremes as tx
from xsdba_tpu_torch.ops import clusters as tc
from xsdba_tpu_torch.ops import fitting as tf


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


FROZEN = os.path.join(os.path.dirname(__file__), "golden", "e2e_scen.npz")
F64 = dict(rtol=0, atol=1e-10, equal_nan=True)


def _t(a, dtype=np.float64):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _np(x):
    return x.data.numpy() if isinstance(x, (xp.DataArray,)) else (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


# ----------------------------------------------------------------- clusters


def _cluster_rows():
    rng = np.random.default_rng(1)
    x = rng.gamma(2, 2, (4, 300))
    x[0, 10:30] = np.nan            # NaN inside and around runs
    x[1, :6] = 9.0                  # a cluster at the start ...
    x[1, -5:] = 9.0                 # ... and one at the end
    x[2, ::3] = 7.0                 # more qualifying runs than the bound
    x[3] = 0.5                      # no exceedance at all
    return x


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("max_clusters", [4, 40, 120])
def test_cluster_fields_equal_reference(dtype, max_clusters):
    x = _cluster_rows().astype(dtype)
    u1 = np.array([[6.0], [6.0], [6.5], [6.0]], dtype)
    want = jc.cluster_fields(x, u1, dtype(2.0), max_clusters=max_clusters)
    got = tc.cluster_fields(_t(x, dtype), _t(u1, dtype), 2.0, max_clusters=max_clusters)
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype or k == "nclusters", (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert int(got["nclusters"][2]) > max_clusters or max_clusters == 120


def test_cluster_maxima_batched_and_scalar_thresholds():
    x = np.random.default_rng(2).gamma(2, 2, (2, 3, 200))
    want = np.asarray(jc.cluster_maxima(x, 8.0, 2.0, max_clusters=30))
    np.testing.assert_array_equal(tc.cluster_maxima(_t(x), 8.0, 2.0, max_clusters=30).numpy(), want)
    # the reference's own hand-checked case
    out = tc.cluster_fields(_t([0, 1, 3, 2, 0, 0, 5, 0, 1, 1, 4, 1, 0, 2.5, 0]), 2.0, 0.5, max_clusters=7)
    np.testing.assert_array_equal(out["start"].numpy()[:4], [1, 6, 8, 13])
    np.testing.assert_array_equal(out["maxpos"].numpy()[:4], [2, 6, 10, 13])


# ------------------------------------------------------------ GPD functions


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 2e-6)])
def test_gpd_cdf_and_ppf_match_reference(dtype, atol):
    rng = np.random.default_rng(3)
    c = np.array([-0.3, 0.0, 0.1, 0.4], dtype)[:, None]
    x = rng.gamma(2, 2, (4, 64)).astype(dtype)
    q = rng.random((4, 64)).astype(dtype)
    loc, scale = dtype(1.5), dtype(2.0)
    want_cdf = np.asarray(jax.jit(jf.gpd_cdf)(x, c, loc, scale))
    want_ppf = np.asarray(jax.jit(jf.gpd_ppf)(q, c, loc, scale))
    tl, ts = _t(loc, dtype), _t(scale, dtype)
    np.testing.assert_allclose(tf.gpd_cdf(_t(x, dtype), _t(c, dtype), tl, ts).numpy(), want_cdf, rtol=0, atol=atol)
    np.testing.assert_allclose(tf.gpd_ppf(_t(q, dtype), _t(c, dtype), tl, ts).numpy(), want_ppf, rtol=0, atol=atol * 10)
    # the support's end for c < 0 and the exponential case c = 0
    assert (tf.gpd_cdf(_t(x, dtype), _t(c, dtype), tl, ts).numpy()[0][x[0] > 1.5 + 2.0 / 0.3] == 1).all()


def _gpd_rows(dtype, rows=24, n=150):
    rng = np.random.default_rng(4)
    xs = np.full((rows, n), np.nan)
    for i in range(rows - 2):
        k = int(rng.integers(5, n))
        xs[i, :k] = stats.genpareto.rvs(rng.uniform(-0.3, 0.4), scale=rng.uniform(0.5, 5), size=k, random_state=i)
    xs[-1, 0] = 1.3                 # a single value; the row before is empty
    return xs.astype(dtype)


def _profile_nll(x, theta):
    """The per-value negative profile log-likelihood at theta, in float64."""
    x = x[~np.isnan(x)]
    xi = np.log1p(theta * x).mean()
    return np.log(xi / theta) + xi + 1


def test_gpd_fit_float64_reaches_the_reference_optimum():
    xs = _gpd_rows(np.float64)
    c1, s1 = (np.asarray(v) for v in jf.gpd_fit_ml(xs))
    c2, s2 = (v.numpy() for v in tf.gpd_fit_ml(_t(xs)))
    np.testing.assert_array_equal(np.isnan(c2), np.isnan(c1))
    assert np.isnan(c2[-2]) and np.isnan(s2[-2])              # the empty row
    np.testing.assert_allclose(c2, c1, rtol=0, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(s2, s1, rtol=1e-6, equal_nan=True)
    for row, a, b, sa, sb in zip(xs[:-2], c1, c2, s1, s2):
        want, got = _profile_nll(row, a / sa), _profile_nll(row, b / sb)
        assert abs(got - want) <= 1e-12 * (1 + abs(want)), (got, want)


def test_gpd_fit_float32_within_stated_tolerance():
    xs = _gpd_rows(np.float32)
    c1, s1 = (np.asarray(v, np.float64) for v in jf.gpd_fit_ml(xs))
    c2, s2 = (v.double().numpy() for v in tf.gpd_fit_ml(_t(xs, np.float32)))
    moved = np.abs(c2 - c1) > 5e-3
    assert not moved.any(), np.abs(c2 - c1)
    np.testing.assert_allclose(s2, s1, rtol=5e-3, equal_nan=True)


def test_gpd_fit_of_a_batch_equals_its_rows_fitted_alone():
    x = _t(_gpd_rows(np.float64)[:6])
    c, s = tf.gpd_fit_ml(x)
    for i in range(x.shape[0]):
        ci, si = tf.gpd_fit_ml(x[i])
        np.testing.assert_array_equal(ci.numpy(), c[i].numpy())
        np.testing.assert_array_equal(si.numpy(), s[i].numpy())


# -------------------------------------------------------------------- cores


def _fit_stand_in(mod):
    """A fit with no reduction (the first excess sets the scale), so both
    packages compute it alike and the cores' own arithmetic is compared."""
    if mod is jnp:
        return lambda x, **_: (jnp.full(x.shape[:-1], -0.15, x.dtype), x[..., 0] + 1.0)
    return lambda x, **_: (torch.full(x.shape[:-1], -0.15, dtype=x.dtype), x[..., 0] + 1.0)


def _core_inputs(dtype, T=1500):
    rng = np.random.default_rng(5)
    ref, hist, sim = rng.gamma(1.2, 4, (3, T)), rng.gamma(1.3, 3.5, (3, T)), rng.gamma(1.3, 4.2, (3, T))
    ref[2, 100:200] = np.nan
    return [a.astype(dtype) for a in (ref, hist, sim, 0.9 * sim)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("reuse", [False, True])
def test_train_core_matches_reference_given_the_fit(monkeypatch, dtype, reuse):
    monkeypatch.setattr(jx, "gpd_fit_ml", _fit_stand_in(jnp))
    monkeypatch.setattr(tx, "gpd_fit_ml", _fit_stand_in(torch))
    ref, hist, _, _ = _core_inputs(dtype)
    T = ref.shape[-1]
    N, C = int(0.05 * T * 1.05), jx._cluster_bound(T, 0.95)
    rp = np.array([[-0.1, 3.0], [0.05, 2.0], [0.2, 4.0]], dtype)
    # a fresh trace, so that the stand-in is what the reference compiles
    core = jax.jit(jx._extremes_train_core.__wrapped__, static_argnames=("n_out", "max_clusters", "use_ref_params"))
    want = core(ref, hist, dtype(1.0), 0.95, rp if reuse else np.zeros((3, 2), dtype), n_out=N, max_clusters=C, use_ref_params=reuse)
    got = tx._extremes_train_core(_t(ref, dtype), _t(hist, dtype), 1.0, 0.95, _t(rp, dtype) if reuse else None, n_out=N, max_clusters=C)
    atol = 1e-10 if dtype == np.float64 else 1e-6
    for name, w, g in zip(("px_hist", "af", "thresh", "ref_params"), want, got):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        np.testing.assert_allclose(g, w, rtol=0 if dtype == np.float64 else 1e-6, atol=atol, equal_nan=True, err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))   # the threshold: fused quantiles, exact


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("interp,extrap", [("linear", "constant"), ("nearest", "nan"), ("linear", "nan")])
def test_adjust_core_matches_reference_given_the_fit(monkeypatch, dtype, interp, extrap):
    monkeypatch.setattr(jx, "gpd_fit_ml", _fit_stand_in(jnp))
    monkeypatch.setattr(tx, "gpd_fit_ml", _fit_stand_in(torch))
    ref, hist, sim, scen = _core_inputs(dtype)
    T = ref.shape[-1]
    N, C = int(0.05 * T * 1.05), jx._cluster_bound(T, 0.95)
    px, af, thresh, _ = (np.asarray(a) for a in jx._extremes_train_core(ref, hist, dtype(1.0), 0.95, np.zeros((3, 2), dtype), n_out=N, max_clusters=C))
    core = jax.jit(jx._extremes_adjust_core.__wrapped__, static_argnames=("interp", "extrapolation", "max_clusters"))
    want = np.asarray(core(sim, scen, px, af, thresh, dtype(1.0), dtype(0.7), dtype(3.0), interp=interp, extrapolation=extrap, max_clusters=C))
    got = tx._extremes_adjust_core(*(_t(a, dtype) for a in (sim, scen, px, af, thresh)), 1.0, 0.7, 3.0,
                                   interp=interp, extrapolation=extrap, max_clusters=C).numpy()
    assert got.dtype == want.dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def test_cores_with_the_real_fit_agree_to_the_fit_precision():
    """Without the stand-in the fits differ at ~1e-8 (C18); the trained
    factors and the adjusted series follow them."""
    ref, hist, sim, scen = _core_inputs(np.float64)
    T = ref.shape[-1]
    N, C = int(0.05 * T * 1.05), jx._cluster_bound(T, 0.95)
    want = [np.asarray(a) for a in jx._extremes_train_core(ref, hist, 1.0, 0.95, np.zeros((3, 2)), n_out=N, max_clusters=C)]
    got = [a.numpy() for a in tx._extremes_train_core(_t(ref), _t(hist), 1.0, 0.95, None, n_out=N, max_clusters=C)]
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, equal_nan=True)   # the shape c is fixed absolutely
    ws = np.asarray(jx._extremes_adjust_core(sim, scen, *want[:3], 1.0, 0.7, 3.0, interp="linear", extrapolation="constant", max_clusters=C))
    gs = tx._extremes_adjust_core(*(_t(a) for a in (sim, scen, *want[:3])), 1.0, 0.7, 3.0, interp="linear", extrapolation="constant", max_clusters=C).numpy()
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-9)


def test_cluster_bound_equals_reference():
    for T, q in ((1095, 0.9), (54750, 0.95), (100, 0.99)):
        assert tx._cluster_bound(T, q) == jx._cluster_bound(T, q)


# --------------------------------------------------------------- public API


def _port_da(da):
    t = da.coords["time"]
    time = xp.date_range(f"{int(t.year[0]):04d}-{int(t.month[0]):02d}-{int(t.day[0]):02d}", periods=len(t), freq="D", calendar=t.calendar)
    coords = {"time": time, **{k: np.asarray(v) for k, v in da.coords.items() if k != "time"}}
    return xp.DataArray(torch.as_tensor(np.array(da.data)), da.dims, coords, dict(da.attrs), da.name)


@pytest.fixture(scope="module")
def e2e():
    d = build_inputs()
    return {k: d[k] for k in ("ref", "hist", "sim")}


@pytest.mark.parametrize("q_thresh,kw", [
    (0.9, dict(frac=0.5, power=2)),
    (0.9, dict(frac=0.3, power=1, interp="nearest", extrapolation="nan")),
])
def test_public_api_matches_reference(e2e, q_thresh, kw):
    """The JAX package pads the time axis to 4096 values; the port computes
    the series as they are: the same outputs."""
    p = {k: _port_da(v) for k, v in e2e.items()}
    want = xt.ExtremeValues.train(e2e["ref"], e2e["hist"], cluster_thresh="1 mm/d", q_thresh=q_thresh)
    got = xp.ExtremeValues.train(p["ref"], p["hist"], cluster_thresh="1 mm/d", q_thresh=q_thresh)
    for k in ("px_hist", "af", "thresh", "ref_params"):
        assert got.ds[k].dims == want.ds[k].dims
        np.testing.assert_allclose(_np(got.ds[k]), np.asarray(want.ds[k].data), err_msg=k, **F64)
    assert got.ds["thresh"].attrs["units"] == "mm/d" and got.cluster_thresh == want.cluster_thresh
    sw = want.adjust(e2e["sim"], e2e["sim"] * 0.9, **kw)
    sg = got.adjust(p["sim"], p["sim"] * 0.9, **kw)
    assert isinstance(sg.data, torch.Tensor) and sg.dims == sw.dims and sg.attrs["units"] == "mm/d"
    np.testing.assert_allclose(_np(sg), np.asarray(sw.data), **F64)


def test_unpadded_port_equals_padded_port_and_reference(e2e):
    p = {k: _port_da(v) for k, v in e2e.items()}
    refa, hista, sima = (p[k].data for k in ("ref", "hist", "sim"))
    T = refa.shape[-1]
    pad = lambda a: torch.nn.functional.pad(a, (0, 4096 - T), value=float("nan"))  # noqa: E731
    N, C = int(0.1 * T * 1.05), tx._cluster_bound(T, 0.9)
    plain = tx._extremes_train_core(refa, hista, 1.0, 0.9, None, n_out=N, max_clusters=C)
    padded = tx._extremes_train_core(pad(refa), pad(hista), 1.0, 0.9, None, n_out=N, max_clusters=C)
    for a, b in zip(plain, padded):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    args = (1.0, 0.5, 2.0)
    out = tx._extremes_adjust_core(sima, 0.9 * sima, *plain[:3], *args, interp="linear", extrapolation="constant", max_clusters=C)
    out_p = tx._extremes_adjust_core(pad(sima), pad(0.9 * sima), *plain[:3], *args, interp="linear", extrapolation="constant", max_clusters=C)
    np.testing.assert_array_equal(out.numpy(), out_p[..., :T].numpy())
    # the reference's public call pads (xsdba_tpu/models/extremes.py:_pad_time)
    want = xt.ExtremeValues.train(e2e["ref"], e2e["hist"], cluster_thresh="1 mm/d", q_thresh=0.9).adjust(e2e["sim"], e2e["sim"] * 0.9, frac=0.5, power=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(want.data), **F64)


def test_interior_fits_hold_the_fit_precision(e2e):
    """With a cluster threshold of 5 mm/d the fits are interior optima and
    part at ~1e-8 (C18)."""
    p = {k: _port_da(v) for k, v in e2e.items()}
    want = xt.ExtremeValues.train(e2e["ref"], e2e["hist"], cluster_thresh="5 mm/d", q_thresh=0.9)
    got = xp.ExtremeValues.train(p["ref"], p["hist"], cluster_thresh="5 mm/d", q_thresh=0.9)
    np.testing.assert_array_equal(_np(got.ds["thresh"]), np.asarray(want.ds["thresh"].data))
    np.testing.assert_allclose(_np(got.ds["ref_params"]), np.asarray(want.ds["ref_params"].data), rtol=1e-6)
    sw = np.asarray(want.adjust(e2e["sim"], e2e["sim"] * 0.9, frac=0.7, power=3).data)
    sg = _np(got.adjust(p["sim"], p["sim"] * 0.9, frac=0.7, power=3))
    np.testing.assert_allclose(sg, sw, rtol=1e-6, atol=1e-9)


def test_ref_params_reuse_and_future_warning(e2e):
    p = {k: _port_da(v) for k, v in e2e.items()}
    first = xp.ExtremeValues.train(p["ref"], p["hist"], cluster_thresh="1 mm/d", q_thresh=0.9)
    hist2 = p["hist"] * 0.8
    want_first = xt.ExtremeValues.train(e2e["ref"], e2e["hist"], cluster_thresh="1 mm/d", q_thresh=0.9)
    want = xt.ExtremeValues.train(e2e["ref"], e2e["hist"] * 0.8, cluster_thresh="1 mm/d", q_thresh=0.9, ref_params=want_first.ds)
    for given in (first.ds, first.ds["ref_params"], _np(first.ds["ref_params"])):
        got = xp.ExtremeValues.train(p["ref"], hist2, cluster_thresh="1 mm/d", q_thresh=0.9, ref_params=given)
        np.testing.assert_array_equal(_np(got.ds["ref_params"]), _np(first.ds["ref_params"]))
        np.testing.assert_allclose(_np(got.ds["af"]), np.asarray(want.ds["af"].data), **F64)
    with pytest.warns(FutureWarning, match="frac"):
        got = first.adjust(p["sim"], p["sim"] * 0.9)
    with pytest.warns(FutureWarning, match="frac"):
        ref_out = want_first.adjust(e2e["sim"], e2e["sim"] * 0.9)
    np.testing.assert_allclose(_np(got), np.asarray(ref_out.data), **F64)
    with warnings.catch_warnings():
        warnings.simplefilter("error", FutureWarning)
        first.adjust(p["sim"], p["sim"] * 0.9, frac=0.7, power=3)


def test_cluster_thresh_in_the_data_units(e2e):
    """``cluster_thresh`` is converted to ref's units: 1 mm/d given in kg m-2 s-1."""
    p = {k: _port_da(v) for k, v in e2e.items()}
    a = xp.ExtremeValues.train(p["ref"], p["hist"], cluster_thresh="1 mm/d", q_thresh=0.9)
    b = xp.ExtremeValues.train(p["ref"], p["hist"], cluster_thresh=f"{1 / 86400} kg m-2 s-1", q_thresh=0.9)
    assert b.cluster_thresh == pytest.approx(1.0, rel=1e-12)
    np.testing.assert_allclose(_np(b.ds["af"]), _np(a.ds["af"]), **F64)


def test_files_cross_the_packages(tmp_path, e2e):
    p = {k: _port_da(v) for k, v in e2e.items()}
    want = xt.ExtremeValues.train(e2e["ref"], e2e["hist"], cluster_thresh="1 mm/d", q_thresh=0.9)
    scen_want = np.asarray(want.adjust(e2e["sim"], e2e["sim"] * 0.9, frac=0.5, power=2).data)
    want.save(tmp_path / "ref_trained")
    loaded = xp.ExtremeValues.from_file(tmp_path / "ref_trained")
    assert type(loaded) is xp.ExtremeValues and loaded.q_thresh == 0.9
    np.testing.assert_allclose(_np(loaded.adjust(p["sim"], p["sim"] * 0.9, frac=0.5, power=2)), scen_want, **F64)
    xp.ExtremeValues.train(p["ref"], p["hist"], cluster_thresh="1 mm/d", q_thresh=0.9).save(tmp_path / "port_trained")
    back = xt.ExtremeValues.from_file(tmp_path / "port_trained")
    np.testing.assert_allclose(np.asarray(back.adjust(e2e["sim"], e2e["sim"] * 0.9, frac=0.5, power=2).data), scen_want, **F64)


def test_e2e_case_matches_frozen(e2e):
    """The ``ExtremeValues`` case of ``tests/e2e_cases.py`` replayed through
    the port (its first-order scen from the port's EQM)."""
    p = {k: _port_da(v) for k, v in e2e.items()}
    scen0 = xp.EmpiricalQuantileMapping.train(p["ref"], p["hist"], kind="*", nquantiles=15).adjust(p["sim"])
    ev = xp.ExtremeValues.train(p["ref"], p["hist"], cluster_thresh="1 mm/d", q_thresh=0.9)
    scen = ev.adjust(p["sim"], scen0, frac=0.5, power=2)
    np.testing.assert_allclose(_np(scen), np.load(FROZEN)["ExtremeValues"], rtol=1e-9, atol=1e-9)
