"""The port's ``processing`` functions, rotations and generator stream against
the JAX package, on the CPU.

Reordering, stacking, the public energy score and the dry-day
preprocessing (jitter, adapt_freq) run on the same numpy inputs through both
packages.  Reordering moves values and rounds nothing, so it is compared
under ``==``; so is the preprocessing, eager in the JAX package, given the
reference's draws.  Rotations are tested by their properties: a
``torch.Generator`` cannot reproduce the reference's Threefry draws.
"""

import jax
import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from e2e_cases import JAX_SEED
from test_torch_qdm import reference_draws
from xsdba_tpu import processing as jproc
from xsdba_tpu.utils.rng import seed as jax_seed
from xsdba_tpu_torch import processing as tproc
from xsdba_tpu_torch.ops.rotation import rand_rot_matrix
from xsdba_tpu_torch.utils import rng as trng


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


N = 365 * 2


def _pair(mod, values, dims=("site", "time"), start="2001-01-01", name="x", units="K"):
    t = mod.date_range(start, periods=values.shape[-1], freq="D", calendar="noleap")
    return mod.DataArray(values, dims, {"time": t}, {"units": units}, name)


def _np(da):
    return da.data.numpy() if isinstance(da.data, torch.Tensor) else np.asarray(da.data)


# --------------------------------------------------------------- reordering


def _reorder_inputs(seed=0):
    rng = np.random.default_rng(seed)
    ref = rng.normal(0, 1, (3, N))
    sim = rng.gamma(2, 2, (3, N))
    ref[0, ::9] = ref[0, 1]            # ties in ref keep their order
    sim[1, ::5] = 0.0                   # ties in sim
    sim[1, 1::10] = -0.0                # -0.0 sorts as equal to +0.0
    ref[2, 40:60] = np.nan              # NaNs rank last
    sim[2, 40:60] = np.nan
    return ref, sim


def test_reordering_core_is_the_double_argsort():
    """The scatter of ``arange`` along the stable argsort gives the integers
    of ``argsort(argsort(ref))``; the core equals the reference's under ==
    (-0.0 equals +0.0: which zero of a tie lands where is free, ROADMAP
    C3)."""
    ref, sim = _reorder_inputs()
    got = tproc._reordering_core(torch.as_tensor(ref), torch.as_tensor(sim)).numpy()
    want = np.asarray(jproc._reordering_core(ref, sim))
    np.testing.assert_array_equal(got, want)
    order = np.argsort(np.argsort(ref, axis=-1, kind="stable"), axis=-1, kind="stable")
    np.testing.assert_array_equal(got, np.take_along_axis(np.sort(sim, axis=-1), order, axis=-1))


@pytest.mark.parametrize("group,window", [("time", 1), ("time.month", 1), ("time.dayofyear", 5), ("time.season", 1)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reordering_matches_reference(group, window, dtype):
    ref, sim = (a.astype(dtype) for a in _reorder_inputs(seed=1))
    want = jproc.reordering(_pair(xt, ref), _pair(xt, sim), group=xt.Grouper(group, window=window))
    got = tproc.reordering(_pair(xp, ref), _pair(xp, sim), group=xp.Grouper(group, window=window))
    assert got.dims == want.dims and got.name == want.name and got.attrs["units"] == "K"
    assert "reordering(ref, sim)" in got.attrs["history"]
    assert _np(got).dtype == dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want.data))


def test_reordering_keeps_the_dim_order_and_sorts_each_series():
    ref, sim = _reorder_inputs(seed=2)
    got = tproc.reordering(_pair(xp, ref.T.copy(), ("time", "site")), _pair(xp, sim.T.copy(), ("time", "site")))
    assert got.dims == ("time", "site")
    out = _np(got).T
    np.testing.assert_array_equal(np.sort(out[:2], axis=-1), np.sort(sim[:2], axis=-1))
    # the reordered series has ref's rank structure
    np.testing.assert_array_equal(np.argsort(out[0], kind="stable")[-5:], np.argsort(ref[0], kind="stable")[-5:])


# ------------------------------------------------------ stack / standardize


def _dataset(mod, seed=3, tensors=False):
    rng = np.random.default_rng(seed)
    t = mod.date_range("2000-01-01", periods=100, freq="D")
    wrap = (lambda a: torch.as_tensor(a)) if tensors else (lambda a: a)
    return mod.Dataset(
        {
            "tas": mod.DataArray(wrap(rng.normal(280, 5, (2, 100))), ("site", "time"), {"time": t}, {"units": "K"}, "tas"),
            "pr": mod.DataArray(wrap(rng.random((2, 100))), ("site", "time"), {"time": t}, {"units": "mm/d"}, "pr"),
        },
        {"title": "demo"},
    )


@pytest.mark.parametrize("tensors", [False, True])
def test_stack_unstack_round_trip(tensors):
    ds = _dataset(xp, tensors=tensors)
    da = tproc.stack_variables(ds)
    want = jproc.stack_variables(_dataset(xt))
    assert da.dims == want.dims == ("multivar", "site", "time")
    assert list(np.asarray(da.coords["multivar"])) == list(np.asarray(want.coords["multivar"])) == ["pr", "tas"]
    assert da.attrs["units"] == "" and da.attrs["_variable_attrs"] == want.attrs["_variable_attrs"]
    assert isinstance(da.data, torch.Tensor) == tensors
    np.testing.assert_array_equal(_np(da), np.asarray(want.data))
    back = tproc.unstack_variables(da)
    assert sorted(back.keys()) == ["pr", "tas"] and back.attrs == {"title": "demo"}
    for name in ("pr", "tas"):
        np.testing.assert_array_equal(_np(back[name]), _np(ds[name]))
        assert back[name].attrs == ds[name].attrs and back[name].dims == ("site", "time")


def test_unstack_needs_a_variable_coordinate():
    da = xp.DataArray(np.zeros((2, 5)), ("multivar", "time"), {"time": xp.date_range("2000-01-01", periods=5, freq="D")})
    with pytest.raises(ValueError, match="No variable coordinate"):
        tproc.unstack_variables(da)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 2e-6)])
def test_standardize_and_unstandardize(dtype, tol):
    rng = np.random.default_rng(4)
    x = rng.normal(5, 3, (3, 200)).astype(dtype)
    x[1, 7:11] = np.nan
    want, wmu, wsd = jproc.standardize(_pair(xt, x))
    got, mu, sd = tproc.standardize(_pair(xp, x))
    assert got.dims == want.dims and got.attrs["units"] == "K"
    np.testing.assert_allclose(_np(got), np.asarray(want.data), rtol=tol, atol=tol, equal_nan=True)
    np.testing.assert_allclose(mu.numpy(), np.asarray(wmu), rtol=tol, atol=tol)
    np.testing.assert_allclose(sd.numpy(), np.asarray(wsd), rtol=tol, atol=tol)
    back = tproc.unstandardize(got, mu, sd)
    np.testing.assert_allclose(_np(back), x, rtol=10 * tol, atol=10 * tol, equal_nan=True)
    np.testing.assert_allclose(_np(back), np.asarray(jproc.unstandardize(want, wmu, wsd).data), rtol=10 * tol, atol=10 * tol, equal_nan=True)
    # given moments are used as they come
    fixed, _, _ = tproc.standardize(_pair(xp, x), mean=1.0, std=2.0)
    np.testing.assert_allclose(_np(fixed), (x - 1) / 2, rtol=tol, atol=tol, equal_nan=True)


# ------------------------------------------------------------ public escore


@pytest.mark.parametrize("N_pts,scale", [(0, False), (50, True), (50, False), (0, True)])
def test_public_escore(N_pts, scale):
    """``N`` (even subsampling) and ``scale`` (tgt's moments, ddof 1) as the
    reference; 1e-6: the score cancels three sums (see the core's tests)."""
    rng = np.random.default_rng(5)
    mv = np.array(["a", "b"])

    def mk(mod, v):
        t = mod.date_range("2000-01-01", periods=v.shape[-1], freq="D")
        return mod.DataArray(v, ("site", "multivar", "time"), {"time": t, "multivar": mv, "site": np.arange(3)}, {}, "x")

    a, b = rng.normal(0, 1, (3, 2, 300)), rng.normal(1, 1.5, (3, 2, 300))
    b[0, 1, 5] = np.nan
    want = jproc.escore(mk(xt, a), mk(xt, b), N=N_pts, scale=scale)
    got = tproc.escore(mk(xp, a), mk(xp, b), N=N_pts, scale=scale)
    assert got.dims == want.dims == ("site",) and got.name == "escores"
    assert got.attrs == want.attrs
    np.testing.assert_allclose(_np(got), np.asarray(want.data), rtol=1e-6)


# -------------------------------------------------- rotations and the stream


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-12)])
def test_rand_rot_matrix_properties(dtype, tol):
    trng.seed(3)
    R = rand_rot_matrix(4, num=5, dtype=dtype)
    assert tuple(R.shape) == (5, 4, 4) and R.dtype == dtype and R.device.type == "cpu"
    eye = torch.eye(4, dtype=dtype).expand(5, 4, 4)
    torch.testing.assert_close(R @ R.transpose(-1, -2), eye, rtol=0, atol=tol * 4)
    torch.testing.assert_close(torch.linalg.det(R).abs(), torch.ones(5, dtype=dtype), rtol=0, atol=tol * 10)
    assert tuple(rand_rot_matrix(3, dtype=dtype).shape) == (3, 3)
    # the same seed replays the draw; consecutive draws differ
    trng.seed(3)
    again = rand_rot_matrix(4, num=5, dtype=dtype)
    torch.testing.assert_close(again, R, rtol=0, atol=0)
    assert not torch.equal(rand_rot_matrix(4, num=5, dtype=dtype), R)
    # an explicit generator leaves the global stream alone
    gen = torch.Generator().manual_seed(11)
    a = rand_rot_matrix(3, num=2, generator=gen, dtype=dtype)
    b = rand_rot_matrix(3, num=2, generator=torch.Generator().manual_seed(11), dtype=dtype)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rand_rot_matrix_is_haar_like():
    """Over many draws every entry has mean 0 and variance 1/n, and both
    signs of the determinant occur (the sign fix makes the draw Haar on
    O(n), as the reference's construction)."""
    trng.seed(0)
    R = rand_rot_matrix(3, num=4000, dtype=torch.float64)
    assert R.mean(dim=0).abs().max() < 0.05
    torch.testing.assert_close(R.var(dim=0), torch.full((3, 3), 1 / 3, dtype=torch.float64), rtol=0, atol=0.03)
    det = torch.linalg.det(R)
    assert (det > 0).any() and (det < 0).any()


def test_generator_stream():
    trng.seed(5)
    g = trng.next_generator()
    assert g is trng.next_generator() and g.device.type == "cpu"
    draw = lambda: torch.randn(4, generator=trng.next_generator(), dtype=torch.float64)  # noqa: E731
    a, b = draw(), draw()
    assert not torch.equal(a, b)
    trng.seed(5)
    torch.testing.assert_close(draw(), a, rtol=0, atol=0)
    trng.seed(6)
    assert not torch.equal(draw(), a)


def test_generator_stream_starts_at_seed_zero():
    """Seed 0 on first use, created lazily: a fresh process draws what
    ``seed(0)`` replays."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import torch; from xsdba_tpu_torch.utils import rng; "
            "print(rng._state['generators'] == {}, torch.randn(3, generator=rng.next_generator(), dtype=torch.float64).tolist())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert out.returncode == 0, out.stderr
    lazy, _, values = out.stdout.strip().partition(" ")
    trng.seed(0)
    assert lazy == "True" and values == str(torch.randn(3, generator=trng.next_generator(), dtype=torch.float64).tolist())

# --------------------------------------------------- dry-day preprocessing
# jitter and frequency adaptation, given the reference's uniform draws: the
# cores take them as an argument, and the public calls draw them through
# ``test_torch_qdm.reference_draws``; the arithmetic is eager in the JAX
# package, so it is compared under ``==``


def pr_series(n, seed=4):
    """Daily precipitation, BASELINE config 2's recipe at a small size: ref
    60 % wet days of Gamma(0.9, 5) mm/d, hist 80 % of Gamma(0.7, 5) (the
    drizzle bias), sim hist's recipe with a 30 % trend, and a hist with 40 %
    wet days, drier than ref, so that adapt_freq replaces some of its dry
    days; 2 sites, ``n`` days each."""
    rng = np.random.default_rng(seed)

    def wet(share, k):
        return rng.gamma(k, 5.0, (2, n)) * (rng.random((2, n)) < share)

    ref, hist = wet(0.6, 0.9), wet(0.8, 0.7)
    sim = wet(0.8, 0.7) * (1 + 0.3 * np.arange(n) / n)
    return ref, hist, sim, wet(0.4, 0.7)


@pytest.fixture(scope="module")
def dry():
    return pr_series(N)


def _jax_uniform(key, shape, dtype, lo, hi):
    return np.array(jax.random.uniform(key, shape, dtype=dtype, minval=lo, maxval=hi))


@pytest.mark.parametrize("case", ["under", "over", "both"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_jitter_core_with_the_reference_draws(dry, case, dtype):
    from xsdba_tpu.processing import _jitter_core as j_jitter

    x = dry[1].astype(dtype)
    x[0, 3] = np.nan
    lower = 0.5 if case != "over" else None
    upper, bnd = (20.0, 30.0) if case != "under" else (None, None)
    key = jax.random.key(7)
    want = np.asarray(j_jitter(x, lower, upper, bnd, key=key))
    under = over = None
    k = key
    if lower is not None:
        k1, k = jax.random.split(k)
        under = _jax_uniform(k1, x.shape, dtype, np.finfo(dtype).eps, lower)
    if upper is not None:
        over = _jax_uniform(jax.random.split(k)[0], x.shape, dtype, upper, bnd)
    got = tproc._jitter_core(torch.from_numpy(x), lower, upper, bnd, draws=(under, over)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0, 3]) and (lower is None or (got[np.isfinite(got)] > 0).all())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_adapt_freq_cores_with_the_reference_draws(dry, dtype):
    """Training (P0 and pth computed) and adjusting (trained P0 and pth)
    forms, on a hist drier than ref (some of its dry days replaced) and on
    the drizzle-biased one (none replaced)."""
    from xsdba_tpu.ops.segment import gather_groups as j_gather
    from xsdba_tpu.processing import _adapt_freq_apply_core as j_apply
    from xsdba_tpu.processing import _adapt_freq_grouped as j_grouped

    ref, hist, sim, drier = (a.astype(dtype) for a in dry)
    t = xt.date_range("2001-01-01", periods=N, freq="D", calendar="noleap")
    gi = xt.Grouper("time.month").indexes(t)
    gip = xp.Grouper("time.month").indexes(_pair(xp, ref).time)
    refg = np.array(j_gather(ref, gi.gather_idx))

    def draws(key, shape):
        k1, k2 = jax.random.split(key)
        return _jax_uniform(k1, shape, dtype, 0.1, 0.25), _jax_uniform(k2, shape, dtype, 0.0, 1.0)

    replaced = []
    for h in (drier, hist):
        histg = np.array(j_gather(h, gi.gather_idx))
        key = jax.random.key(3)
        want = j_grouped(refg, histg, 1.0, key=key)
        got = tproc._adapt_freq_grouped(torch.from_numpy(refg), torch.from_numpy(histg), 1.0, draws=draws(key, histg.shape))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        replaced.append(int((got[0].numpy() != histg)[~np.isnan(histg)].sum()))
    assert replaced[0] > replaced[1]     # the drier hist has more dry days to replace
    _, P0_ref, P0_hist, pth, _ = want
    key = jax.random.key(5)
    want_ad = np.asarray(j_apply(sim, gi, 1.0, P0_ref, P0_hist, pth, key=key))
    got_ad = tproc._adapt_freq_apply_core(torch.from_numpy(sim), gip, 1.0, *(np.asarray(a) for a in (P0_ref, P0_hist, pth)), draws=draws(key, (2, 12, gi.gather_idx.shape[1])))
    np.testing.assert_array_equal(got_ad.numpy(), want_ad)


def test_public_adapt_freq_and_jitter(dry, monkeypatch):
    """``processing.adapt_freq`` and the jitter functions through the public
    surface, the port drawing the reference's draws for the same seed."""
    reference_draws(monkeypatch)
    (jr, jd, js), (pr, pd, ps) = ([_pair(mod, a, units="mm/d", name="pr") for a in (dry[0], dry[3], dry[2])] for mod in (xt, xp))
    jax_seed(JAX_SEED)
    want = xt.processing.adapt_freq(jr, jd, group="time.month", thresh="1 mm/d")
    jax_seed(JAX_SEED)
    got = xp.processing.adapt_freq(pr, pd, group="time.month", thresh="1 mm/d")
    for name in ("sim_ad", "pth", "dP0", "P0_ref", "P0_hist"):
        assert got[name].dims == want[name].dims
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]))
    for fn, args in (("jitter_under_thresh", ("0.5 mm/d",)), ("jitter_over_thresh", ("20 mm/d", "30 mm/d")), ("jitter", ("0.5 mm/d", "20 mm/d", None, "30 mm/d"))):
        jax_seed(JAX_SEED)
        want = getattr(xt.processing, fn)(js, *args)
        jax_seed(JAX_SEED)
        np.testing.assert_array_equal(_np(getattr(xp.processing, fn)(ps, *args)), _np(want))


# ------------------------------------------------- the rest of processing.py
#
# Tolerances.  Whatever moves or compares values without rounding (ranks,
# sorts, clusters, group indexes, nearest broadcasts, the draws) is held under
# ``==``.  Elementwise transcendentals (log, exp) and sums (group means, FFTs)
# round in other places in the two packages: float64 at 1e-12 and float32 at
# 2e-6, relative, the absolute part scaled by the result's largest value.


def _close(got, want, dtype):
    tol = 1e-12 if np.dtype(dtype) == np.float64 else 2e-6
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, rtol=tol, atol=tol * np.nanmax(np.abs(want)), equal_nan=True)


def _attrs(da):
    """attrs with the history's last entry cut to its call (each package
    signs it with its own name and version)."""
    out = dict(da.attrs)
    if "history" in out:
        out["history"] = out["history"].split("\n")[-1].split("] : ")[-1].split(" - ")[0]
    return out


def reference_noise(monkeypatch):
    """The port's noise (``uniform_noise_like``, ``rank``'s and
    ``random_tiebreak``'s tie-breaks) drawn as the JAX package draws it: the
    JAX stream's next key, in the data's dtype."""
    from xsdba_tpu.utils.rng import next_key

    def noise(x, lo, hi):
        return torch.from_numpy(_jax_uniform(next_key(), tuple(x.shape), np.float64 if x.dtype == torch.float64 else np.float32, lo, hi))

    monkeypatch.setattr(tproc, "_noise_draws", noise)


@pytest.mark.parametrize("trans,kw", [
    ("log", dict(lower_bound="0 mm/d")),
    ("log", dict(lower_bound="-0.5 mm/d", clip_next_to_bounds="strict")),
    ("logit", dict(lower_bound="0 mm/d", upper_bound="200 mm/d")),
    ("logit", dict(lower_bound="0 mm/d", upper_bound="40 mm/d", clip_next_to_bounds="permissive")),
], ids=["log", "log-strict", "logit", "logit-permissive"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_additive_space_matches_reference(dry, trans, kw, dtype):
    x = dry[0].astype(dtype) + 0.01
    x[1, 7] = np.nan
    j, t = _pair(xt, x, units="mm/d", name="pr"), _pair(xp, x, units="mm/d", name="pr")
    want, got = xt.processing.to_additive_space(j, trans=trans, **kw), xp.processing.to_additive_space(t, trans=trans, **kw)
    assert _attrs(got) == _attrs(want) and _np(got).dtype == dtype
    _close(_np(got), _np(want), dtype)
    back_w, back_g = xt.processing.from_additive_space(want), xp.processing.from_additive_space(got)
    assert back_g.attrs["units"] == "mm/d" and back_g.attrs.keys() == back_w.attrs.keys()
    _close(_np(back_g), _np(back_w), dtype)
    if "clip_next_to_bounds" not in kw:
        _close(_np(back_g), x, dtype)        # the round trip
    explicit = xp.processing.from_additive_space(got, trans=trans, units="mm/d", **{k: v for k, v in kw.items() if k.endswith("bound")})
    np.testing.assert_array_equal(_np(explicit), _np(back_g))


def test_additive_space_refusals(dry):
    t = _pair(xp, dry[0], units="mm/d")
    with pytest.raises(ValueError, match="strict"):
        xp.processing.to_additive_space(t, lower_bound="1 mm/d", clip_next_to_bounds="strict")
    with pytest.raises(ValueError, match="upper_bound"):
        xp.processing.to_additive_space(t, lower_bound="0 mm/d", trans="logit")
    with pytest.raises(ValueError, match="all parameters"):
        xp.processing.from_additive_space(t, trans="log")


def _latlon(mod, dtype, T=20, ny=12, nx=16):
    """A [time, lat, lon] field at 0.25 degrees with a large-scale gradient
    and small-scale noise."""
    rng = np.random.default_rng(8)
    lat, lon = 45 + 0.25 * np.arange(ny), -75 + 0.25 * np.arange(nx)
    x = 280 + np.linspace(0, 6, ny)[None, :, None] + np.cos(np.arange(nx) / 3)[None, None] + rng.normal(0, 1, (T, ny, nx))
    t = mod.date_range("2000-01-01", periods=T, freq="D", calendar="noleap")
    return mod.DataArray(x.astype(dtype), ("time", "lat", "lon"), {"time": t, "lat": lat, "lon": lon}, {"units": "K"}, "tas")


@pytest.mark.parametrize("kw", [
    dict(lam_long="200 km", lam_short="60 km"),
    dict(lam_long="200 km", lam_short="60 km", delta="25 km"),
    dict(alpha_low_high=(0.1, 0.4)),
], ids=["delta-from-lat", "delta", "alpha"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_spectral_filter_matches_reference(kw, dtype):
    """The DCT low-pass filter over lat and lon: float64 at 1e-12 and float32
    at 2e-6 of the field's scale (``torch.fft`` and ``jnp.fft`` round
    differently)."""
    j, t = _latlon(xt, dtype), _latlon(xp, dtype)
    want, got = xt.processing.spectral_filter(j, dims=["lat", "lon"], **kw), xp.processing.spectral_filter(t, dims=["lat", "lon"], **kw)
    assert got.dims == want.dims and _attrs(got) == _attrs(want)
    assert _np(got).dtype == dtype
    _close(_np(got), _np(want), dtype)
    assert np.abs(_np(got) - _np(t)).max() > 0.1          # the small scales went


def test_dct_round_trip_and_delta_estimate():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 7, 10)))
    for axis in (1, 2):
        np.testing.assert_allclose(tproc._idct2(tproc._dct2(x, axis), axis).numpy(), x.numpy(), atol=1e-12)
    assert xp.processing.estimate_delta_from_cf(_latlon(xp, np.float64)) == xt.processing.estimate_delta_from_cf(_latlon(xt, np.float64))
    flat = xp.DataArray(np.zeros((2, 3)), ("time", "x"), {"x": np.arange(3)}, {}, "v")
    with pytest.raises(ValueError, match="latitude-like"):
        xp.processing.estimate_delta_from_cf(flat)
    mask = tproc.cos2_mask_func(torch.tensor([0.0, 0.1, 0.25, 0.4, 0.9], dtype=torch.float64), 0.1, 0.4).numpy()
    np.testing.assert_allclose(mask, np.asarray(jproc.cos2_mask_func(np.array([0.0, 0.1, 0.25, 0.4, 0.9]), 0.1, 0.4)), atol=1e-15)


@pytest.mark.parametrize("group,kind", [("time.month", "+"), ("time.season", "*"), ("time", "+")])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_normalize_matches_reference(dry, group, kind, dtype):
    x = dry[1].astype(dtype) + 1.0
    x[0, 30:40] = np.nan
    (wa, wn), (ga, gn) = (mod.processing.normalize(_pair(mod, x, units="mm/d"), group=group, kind=kind) for mod in (xt, xp))
    assert ga.dims == wa.dims and gn.dims == wn.dims and gn.attrs["units"] == "mm/d"
    _close(_np(gn), _np(wn), dtype)
    _close(_np(ga), _np(wa), dtype)
    again, _ = xp.processing.normalize(_pair(xp, x, units="mm/d"), norm=gn, group=group, kind=kind)
    np.testing.assert_array_equal(_np(again), _np(ga))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_uniform_noise_like(monkeypatch, dtype):
    """The port's own stream: its dtype, shape and range, and a seed replays
    it; given the reference's draws (float64, which the reference draws
    whatever the data's dtype), the reference's noise."""
    da = _pair(xp, np.zeros((2, 1000), dtype=dtype))
    trng.seed(4)
    a = _np(xp.processing.uniform_noise_like(da, low=0.5, high=2.0))
    trng.seed(4)
    b = _np(xp.processing.uniform_noise_like(da, low=0.5, high=2.0))
    assert a.dtype == dtype and a.shape == (2, 1000) and (a >= 0.5).all() and (a < 2.0).all()
    np.testing.assert_array_equal(a, b)
    assert abs(a.mean() - 1.25) < 0.05
    if dtype is np.float64:
        reference_noise(monkeypatch)
        jax_seed(JAX_SEED)
        want = _np(xt.processing.uniform_noise_like(_pair(xt, np.zeros((2, 1000)))))
        jax_seed(JAX_SEED)
        np.testing.assert_array_equal(_np(xp.processing.uniform_noise_like(da)), want)


def test_grouped_time_indexes():
    for mod in (xt, xp):
        t = mod.date_range("2001-01-01", periods=N, freq="D", calendar="noleap")
        got = mod.processing.grouped_time_indexes(t, mod.Grouper("time.dayofyear", window=5))
        if mod is xt:
            want = got
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[0].shape[0] == got[1].shape[0] == 365 and got[1].shape[1] > got[0].shape[1]


@pytest.mark.parametrize("pct", [False, True])
@pytest.mark.parametrize("tiebreak", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rank_and_sort_match_reference(monkeypatch, dry, pct, tiebreak, dtype):
    """Average ranks (ties and NaN), percentile ranks, the random tie-break
    given the reference's draws, and the sort: ``==``."""
    reference_noise(monkeypatch)
    x = dry[0].astype(dtype)
    x[1, 10:20] = np.nan
    out = {}
    for mod in (xt, xp):
        jax_seed(JAX_SEED)
        out[mod] = mod.processing.rank(_pair(mod, x, dims=("site", "time")), pct=pct, use_random_tiebreak=tiebreak)
    assert out[xp].dims == out[xt].dims and out[xp].attrs["units"] == ""
    np.testing.assert_array_equal(_np(out[xp]), _np(out[xt]))
    if tiebreak and dtype is np.float64:
        r = _np(out[xp])[0]
        assert len(np.unique(r)) == len(r)       # no ties left
    srt = xp.processing.sort_along_dim(_pair(xp, x))
    np.testing.assert_array_equal(_np(srt), _np(xt.processing.sort_along_dim(_pair(xt, x))))


def test_get_clusters_matches_reference(dry):
    x = dry[0].copy()
    x[0, 50] = np.nan
    want, got = (mod.processing.get_clusters(_pair(mod, x), 10.0, 2.0) for mod in (xt, xp))
    for name in ("start", "end", "maxpos", "maximum", "nclusters"):
        assert got[name].dims == want[name].dims
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]))


@pytest.mark.parametrize("group,interp", [("time.month", "nearest"), ("time.month", "linear"), ("time.season", "linear"), ("time", "nearest")])
def test_broadcast_matches_reference(group, interp):
    """Grouped factors onto the time axis, and with ``sel`` a quantile
    dimension consumed by each time step's rank (NaN outside the nodes'
    span for linear)."""
    rng = np.random.default_rng(3)
    nq = 5
    q = np.linspace(0.1, 0.9, nq)
    out = {}
    for mod in (xt, xp):
        t = mod.date_range("2001-01-01", periods=N, freq="D", calendar="noleap")
        gi = mod.Grouper(group).indexes(t)
        prop = "group" if gi.prop == "group" else gi.prop
        G = len(gi.positions)
        f = np.random.default_rng(1).normal(size=(2, G, nq))
        grouped = mod.DataArray(f, ("site", prop, "quantiles"), {"quantiles": q, prop: gi.coord}, {"units": ""}, "af")
        x = _pair(mod, np.zeros((2, N)))
        ranks = mod.DataArray(rng.uniform(0, 1, (2, N)) if mod is xt else out[xt][2], ("site", "time"), {"time": t}, {}, "r")
        plain = mod.processing.broadcast(mod.DataArray(f[..., 0], ("site", prop), {prop: gi.coord}, {}, "f"), x, group=group, interp=interp)
        sel = mod.processing.broadcast(grouped, x, group=group, interp=interp, sel={"quantiles": ranks})
        out[mod] = plain, sel, _np(ranks)
    for g, w in zip(out[xp][:2], out[xt][:2]):
        assert g.dims == w.dims
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-12, atol=1e-12, equal_nan=True)
    assert np.isnan(_np(out[xp][1])).any() == (interp == "linear")


@pytest.mark.parametrize("group,method", [("time.month", "linear"), ("time.month", "nearest"), ("time.season", "cubic"), ("time", "linear"), ("time", "cubic")])
@pytest.mark.parametrize("mode", ["blend", "reference"])
def test_interp_on_quantiles_matches_reference(group, method, mode):
    """The public lookup, grouped and ungrouped, in both modes.  The JAX
    package's public call is eager: its ungrouped linear interpolation
    rounds ``y0 + t (y1 - y0)`` twice where the port (as every adjust)
    fuses it, so linear and cubic are held at 1e-12; nearest under
    ``==``."""
    rng = np.random.default_rng(4)
    nq = 12
    out = {}
    for mod in (xt, xp):
        t = mod.date_range("2001-01-01", periods=N, freq="D", calendar="noleap")
        gi = mod.Grouper(group).indexes(t)
        prop = "group" if gi.prop == "group" else gi.prop
        G = len(gi.positions)
        r = np.random.default_rng(5)
        xq = np.sort(r.normal(0, 2, (2, G, nq)), axis=-1)
        yq = r.normal(0, 1, (2, G, nq))
        dims = ("site", prop, "quantiles") if group != "time" else ("site", "quantiles")
        sl = (slice(None), 0) if group == "time" else (slice(None),)
        mk = lambda a, nm: mod.DataArray(a[sl], dims, {"quantiles": np.arange(nq)}, {}, nm)  # noqa: E731
        newx = _pair(mod, np.random.default_rng(6).normal(0, 2.5, (2, N)))
        out[mod] = mod.processing.interp_on_quantiles(newx, mk(xq, "x"), mk(yq, "y"), group=group, method=method, mode=mode)
    assert out[xp].dims == out[xt].dims
    if method == "nearest":
        np.testing.assert_array_equal(_np(out[xp]), _np(out[xt]))
    else:
        np.testing.assert_allclose(_np(out[xp]), _np(out[xt]), rtol=1e-12, atol=1e-12, equal_nan=True)
