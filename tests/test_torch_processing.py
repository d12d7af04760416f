"""The port's ``processing`` functions, rotations and generator stream against
the JAX package, on the CPU.

Reordering, stacking and the public energy score run on the same numpy
inputs through both packages.  Reordering moves values and rounds nothing, so
it is compared under ``==``.  Rotations are tested by their properties: a
``torch.Generator`` cannot reproduce the reference's Threefry draws.
"""

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu import processing as jproc
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
