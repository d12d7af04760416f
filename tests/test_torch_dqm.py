"""The port's DetrendedQuantileMapping and dry-day preprocessing against the
JAX package, on the CPU.

Held under ``==``:
- the scaling of sim by its group's factor: the JAX package blends the two
  bracketing groups eagerly, every operation rounded, and so does the port
  (ROADMAP C11);
- the quantile-mapping step given the reference's detrended series and
  tables (the compiled ``qm_adjust_core``, whose fused rounding the port
  reproduces);
- the public DQM with frequency adaptation and jitter, given the
  reference's uniform draws: ``torch.Generator`` cannot reproduce JAX's
  Threefry stream (ROADMAP C4), so :func:`test_torch_qdm.reference_draws`
  makes the port draw what the JAX package draws for the same seed (the
  preprocessing cores themselves: ``tests/test_torch_processing.py``).

Held at 1e-12 (float64) and 2e-6 (float32): the trained tables, whose group
means are sums XLA and PyTorch add in different orders; the public ``scen``
in float64 at 1e-10 (it passes through a fitted trend).  A windowed
dayofyear group's mean is the difference of two running sums over the
year's extended groups (``_windowed_group_mean``, as the JAX package
computes it), whose float32 rounding depends on the order XLA's scan adds
them in: an ulp of sums of ~1e4 is ~1e-5 of a mean near 10, so float32
windowed means and the tables normalized by them are held at 5e-5 (so is
the gathered train beside them: its additive factors near 0 are
differences of values near 10).
"""

import os

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from e2e_cases import JAX_SEED, build_inputs
from test_torch_processing import pr_series
from test_torch_qdm import _port_da, reference_draws
from xsdba_tpu.models import _algos as jalgos
from xsdba_tpu.utils.rng import seed as jax_seed
from xsdba_tpu_torch.models import _algos
from xsdba_tpu_torch.models._wrap import device_brackets
from xsdba_tpu_torch.ops.correction import equally_spaced_nodes


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


FROZEN = os.path.join(os.path.dirname(__file__), "golden", "e2e_scen.npz")
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12, equal_nan=True), np.float32: dict(rtol=2e-6, atol=2e-6, equal_nan=True)}
SCEN64 = dict(rtol=1e-10, atol=1e-10, equal_nan=True)
WINDOWED = {np.float64: TOL[np.float64], np.float32: dict(rtol=5e-5, atol=5e-5, equal_nan=True)}
N = 365 * 3
DOY31 = ("time.dayofyear", 31)
DTYPES = [np.float64, np.float32]


def _grouper(mod, group):
    return mod.Grouper(*group) if isinstance(group, tuple) else mod.Grouper(group)


def _series(mod, values, start="1991-01-01"):
    t = mod.date_range(start, periods=values.shape[-1], freq="D", calendar="noleap")
    return mod.DataArray(values, ("site", "time"), {"time": t}, {"units": "mm/d"}, "pr")


def _np(da):
    return da.data.numpy() if isinstance(da.data, torch.Tensor) else np.asarray(da.data)


@pytest.fixture(scope="module")
def wet():
    """Positive daily series (no dry days) with a seasonal cycle; sim has a
    trend and a missing value."""
    rng = np.random.default_rng(21)
    season = 1.0 + 0.4 * np.sin(2 * np.pi * np.arange(N) / 365.0)
    ref, hist, sim = (rng.gamma(k, s, (2, N)) * season + 0.1 for k, s in ((4, 2), (6, 1.5), (7, 1.6)))
    sim *= 1 + 0.3 * np.arange(N) / N
    sim[1, 40] = np.nan
    return ref, hist, sim


@pytest.fixture(scope="module")
def dry():
    """The config-2 recipe at a small size (``test_torch_processing.pr_series``)."""
    return pr_series(N)


def _pair(arrays, dtype, starts=("1991-01-01", "1991-01-01", "2051-01-01")):
    arrays = [a.astype(dtype) for a in arrays]
    return [_series(xt, a, s) for a, s in zip(arrays, starts)], [_series(xp, torch.from_numpy(a), s) for a, s in zip(arrays, starts)]


# ------------------------------------------------------------- train cores


@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_group_mean(wet, dtype):
    """Sliding sums of the window-1 groups' sums, edge groups exact."""
    x = wet[1].astype(dtype)
    x[0, 100:130] = np.nan
    t = xt.date_range("1991-01-01", periods=N, freq="D", calendar="noleap")
    want = np.asarray(jalgos._windowed_group_mean(x, xt.Grouper(*DOY31).indexes(t).merge_plan))
    got = _algos._windowed_group_mean(torch.from_numpy(x), xp.Grouper(*DOY31).indexes(_series(xp, x).time).merge_plan)
    np.testing.assert_allclose(got.numpy(), want, **WINDOWED[dtype])


@pytest.mark.parametrize("dtype,kind", [(np.float64, "*"), (np.float32, "+")])
def test_dqm_train_windowed(wet, dtype, kind):
    """The windowed train (raw quantiles, normalized after) equals the
    gathered one (normalized rows, sorted) in both packages, and the
    reference's; for ``kind="*"`` a site has negative means, whose
    quantile axis flips."""
    ref, hist = (a.astype(dtype) for a in wet[:2])
    if kind == "*":
        ref[1], hist[1] = -ref[1], -hist[1]
    t = xt.date_range("1991-01-01", periods=N, freq="D", calendar="noleap")
    gi_j = xt.Grouper(*DOY31).indexes(t)
    gi_p = xp.Grouper(*DOY31).indexes(_series(xp, ref).time)
    q = equally_spaced_nodes(15).astype(dtype)
    got = _algos.dqm_train_windowed(torch.from_numpy(ref), torch.from_numpy(hist), gi_p.merge_plan, torch.from_numpy(q), kind=kind)
    raw = _algos.dqm_train_from_raw(torch.from_numpy(ref), torch.from_numpy(hist), torch.from_numpy(gi_p.gather_idx), torch.from_numpy(q), kind=kind)
    want = jalgos.dqm_train_windowed(ref, hist, gi_j.merge_plan, q, kind=kind)
    want_raw = jalgos.dqm_train_from_raw(ref, hist, gi_j.gather_idx, q, kind=kind)
    for g, r, w, wr in zip(got, raw, want, want_raw):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **WINDOWED[dtype])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **WINDOWED[dtype])
        np.testing.assert_allclose(r.numpy(), np.asarray(wr), **WINDOWED[dtype])


@pytest.mark.parametrize("group", ["time", "time.month", DOY31])
@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dqm_trained_tables(wet, group, kind, dtype):
    (jr, jh, _), (pr, ph, _) = _pair(wet, dtype)
    want = xt.DetrendedQuantileMapping.train(jr, jh, kind=kind, group=_grouper(xt, group), nquantiles=15)
    got = xp.DetrendedQuantileMapping.train(pr, ph, kind=kind, group=_grouper(xp, group), nquantiles=15)
    for name in ("af", "hist_q", "scaling"):
        assert got.ds[name].dims == want.ds[name].dims
        np.testing.assert_allclose(_np(got.ds[name]), _np(want.ds[name]), **(WINDOWED if isinstance(group, tuple) else TOL)[dtype])


# --------------------------------------------------------------- adjust steps


@pytest.mark.parametrize("group", ["time.month", DOY31])
@pytest.mark.parametrize("dtype", DTYPES)
def test_scaling_of_sim_is_the_eager_blend(wet, group, dtype):
    """C11: the reference blends the two bracketing groups' scaling factors
    eagerly (``_algos.broadcast_groups_core`` then ``apply_correction``),
    every operation rounded; the port's scaled series is the same under
    ``==`` (and the blend rounded once is not)."""
    from xsdba_tpu.models._wrap import device_brackets as j_brackets
    from xsdba_tpu.ops.correction import apply_correction as j_apply
    from xsdba_tpu_torch.models.dqm import _scaled

    (jr, jh, js), _ = _pair(wet, dtype)
    scaling = np.asarray(xt.DetrendedQuantileMapping.train(jr, jh, kind="*", group=_grouper(xt, group), nquantiles=15).ds["scaling"].data)
    sim = np.array(js.data)
    gi = _grouper(xt, group).indexes(js.time)
    interp_b = "linear" if gi.prop != "dayofyear" else "nearest"
    want = np.asarray(j_apply(sim, jalgos.broadcast_groups_core(scaling, j_brackets(gi, interp_b)), "*"))
    gip = _grouper(xp, group).indexes(_series(xp, sim, "2051-01-01").time)
    got = _scaled(torch.from_numpy(sim), scaling, gip, "linear", "*").numpy()
    np.testing.assert_array_equal(got, want)
    if gi.prop == "month":
        fused = _algos.broadcast_groups_core(torch.from_numpy(scaling.copy()), device_brackets(gip, "linear"), fused=True) * torch.from_numpy(sim)
        assert (fused.numpy() != want).any()


@pytest.mark.parametrize("group", ["time.month", DOY31])
@pytest.mark.parametrize("interp", ["nearest", "linear"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_qm_step_given_the_reference_detrended_series(wet, group, interp, dtype):
    """The quantile-mapping step of the adjust, handed the reference's
    detrended series and trained tables, equals the reference's under ``==``."""
    (jr, jh, js), _ = _pair(wet, dtype)
    trained = xt.DetrendedQuantileMapping.train(jr, jh, kind="*", group=_grouper(xt, group), nquantiles=15)
    gi = _grouper(xt, group).indexes(js.time)
    interp_b = interp if gi.prop != "dayofyear" else "nearest"
    from xsdba_tpu.models._wrap import device_brackets as j_brackets
    from xsdba_tpu.ops.correction import apply_correction as j_apply

    scaled = j_apply(np.asarray(js.data), jalgos.broadcast_groups_core(np.asarray(trained.ds["scaling"].data), j_brackets(gi, interp_b)), "*")
    scaled_da = xt.DataArray(np.asarray(scaled), js.dims, dict(js.coords), dict(js.attrs), "pr")
    det = np.asarray(xt.detrending.PolyDetrend(degree=1, kind="*", group=_grouper(xt, group)).fit(scaled_da).detrend(scaled_da).data)
    hist_q, af = (np.asarray(trained.ds[k].data) for k in ("hist_q", "af"))
    kw = dict(kind="*", interp=interp, extrapolation="constant", tables_compact=True)
    want = np.asarray(jalgos.qm_adjust_core(det, hist_q, af, j_brackets(gi, interp), **kw))
    gip = _grouper(xp, group).indexes(_series(xp, det, "2051-01-01").time)
    got = _algos.qm_adjust_core(*(torch.from_numpy(a.copy()) for a in (det, hist_q, af)), device_brackets(gip, interp), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- public API


PUBLIC = [
    ("time.month", dict(interp="nearest"), dict()),
    ("time.month", dict(interp="linear", detrend=3), dict(max_tail_factor=1.5)),
    (DOY31, dict(interp="nearest"), dict()),
    (DOY31, dict(interp="linear", extrapolation="nan"), dict()),
    ("time", dict(interp="nearest", detrend="loess"), dict()),
    ("time.month", dict(interp="nearest", mode="reference"), dict(kind="+")),
]


def _detrend(mod, spec, group):
    if spec == "loess":
        return mod.detrending.LoessDetrend(group="time", kind="*", f=0.2, niter=1, d=0)
    return spec


@pytest.mark.parametrize("group,adjust_kw,train_kw", PUBLIC)
def test_public_dqm_scen(wet, group, adjust_kw, train_kw):
    """Train then adjust through the public classes, float64: ``scen`` at
    1e-10, the fitted trend beside it under ``extra_output``."""
    (jr, jh, js), (pr, ph, ps) = _pair(wet, np.float64)
    train_kw = dict(dict(kind="*", nquantiles=15), **train_kw)
    out = {}
    for mod, (r, h, s) in ((xt, (jr, jh, js)), (xp, (pr, ph, ps))):
        kw = dict(adjust_kw, detrend=_detrend(mod, adjust_kw.get("detrend", 1), group))
        with mod.set_options(extra_output=True):
            out[mod] = mod.DetrendedQuantileMapping.train(r, h, group=_grouper(mod, group), **train_kw).adjust(s, **kw)
    for name in ("scen", "trend"):
        np.testing.assert_allclose(_np(out[xp][name]), _np(out[xt][name]), **SCEN64)
    assert out[xp]["scen"].attrs["units"] == "mm/d" and "bias_adjustment" in out[xp]["scen"].attrs


def test_e2e_case_matches_frozen():
    """The ``tests/e2e_cases.py`` DQM case, replayed through the port."""
    d = build_inputs()
    ref, hist, sim = (_port_da(d[k]) for k in ("ref", "hist", "sim"))
    scen = xp.DetrendedQuantileMapping.train(ref, hist, kind="*", nquantiles=15).adjust(sim, detrend=1)
    np.testing.assert_allclose(_np(scen), np.load(FROZEN)["DetrendedQuantileMapping"], rtol=1e-12, atol=1e-12)


def test_files_cross_the_packages(tmp_path, dry, monkeypatch):
    """A DQM trained with frequency adaptation and saved by the JAX package
    loads in the port and adjusts alike (the same draws); the port's file
    loads back in the JAX package."""
    reference_draws(monkeypatch)
    (jr, jh, js), (_, _, ps) = _pair(dry[:3], np.float64)
    kw = dict(kind="*", group="time.month", nquantiles=15, adapt_freq_thresh="1 mm/d", jitter_under_thresh_value="0.01 mm/d")
    jax_seed(JAX_SEED)
    trained = xt.DetrendedQuantileMapping.train(jr, jh, **kw)
    path = str(tmp_path / "dqm")
    trained.save(path)
    jax_seed(JAX_SEED + 1)
    want = _np(trained.adjust(js, interp="nearest"))
    loaded = xp.DetrendedQuantileMapping.from_file(path)
    assert type(loaded) is xp.DetrendedQuantileMapping and loaded.adapt_freq_thresh == "1 mm/d"
    jax_seed(JAX_SEED + 1)
    np.testing.assert_allclose(_np(loaded.adjust(ps, interp="nearest")), want, **SCEN64)
    back = str(tmp_path / "back")
    loaded.save(back)
    jax_seed(JAX_SEED + 1)
    np.testing.assert_allclose(_np(xt.DetrendedQuantileMapping.from_file(back).adjust(js, interp="nearest")), want, **SCEN64)


# -------------------------------------------------- dry-day preprocessing


@pytest.mark.parametrize("dtype", DTYPES)
def test_public_dqm_with_preprocessing(dry, monkeypatch, dtype, group="time.month"):
    """Config 2's preprocessing at a small size: frequency adaptation and
    jitter under 0.01 mm/d, multiplicative, the port drawing the
    reference's draws; float64 ``scen`` at 1e-10, float32 at 2e-6."""
    reference_draws(monkeypatch)
    (jr, jh, js), (pr, ph, ps) = _pair(dry[:3], dtype)
    kw = dict(kind="*", nquantiles=15, adapt_freq_thresh="1 mm/d", jitter_under_thresh_value="0.01 mm/d")
    out = {}
    for mod, (r, h, s) in ((xt, (jr, jh, js)), (xp, (pr, ph, ps))):
        jax_seed(JAX_SEED)
        trained = mod.DetrendedQuantileMapping.train(r, h, group=_grouper(mod, group), **kw)
        out[mod] = trained, trained.adjust(s, interp="nearest", detrend=mod.detrending.LoessDetrend(group="time", kind="*", f=0.2, niter=1, d=0))
    for name in ("P0_ref", "P0_hist", "pth"):
        np.testing.assert_array_equal(_np(out[xp][0].ds[name]), _np(out[xt][0].ds[name]))
    for name in ("af", "hist_q", "scaling"):
        np.testing.assert_allclose(_np(out[xp][0].ds[name]), _np(out[xt][0].ds[name]), **TOL[dtype])
    got, want = _np(out[xp][1]), _np(out[xt][1])
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **(SCEN64 if dtype == np.float64 else TOL[dtype]))
