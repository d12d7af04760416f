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
