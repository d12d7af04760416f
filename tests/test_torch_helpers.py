"""``xsdba_tpu_torch.utils``: its helpers (``utils/helpers.py``) and every name
``xsdba_tpu.utils`` resolves, against the JAX package, on the CPU.

The helpers move, compare or count values, so they are held under ``==``,
but for ``map_cdf`` (a quantile lerp) and ``ecdf`` (a count over a count) at
1e-12.  The draws (``random_tiebreak``, ``rand_rot_matrix``) come from the
port's own ``torch.Generator`` stream, which cannot reproduce the JAX
package's Threefry draws (ROADMAP C4): given the JAX package's draws the
tie-break equals the reference's, and each distribution is checked on its
own.
"""

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu.utils as ju
import xsdba_tpu_torch as xp
import xsdba_tpu_torch.utils as tu
from e2e_cases import JAX_SEED
from test_torch_processing import reference_noise
from xsdba_tpu.utils.rng import seed as jax_seed
from xsdba_tpu_torch.utils import rng as trng


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


def _np(x):
    x = getattr(x, "data", x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_") and not isinstance(getattr(mod, n), type(np)))


def test_every_reference_utils_name_resolves():
    """The 30 names ``xsdba_tpu.utils`` resolved and the port's did not, and
    every other: each resolves, to a callable where the reference's is one,
    and the lazy re-exports to the port's module of the same name."""
    names = sorted(set(_public(ju)) | set(ju._LAZY))
    missing = [n for n in names if not hasattr(tu, n)]
    assert not missing, missing
    for n in names:
        assert callable(getattr(tu, n)) == callable(getattr(ju, n)), n
    for n, target in ju._LAZY.items():
        assert tu._LAZY[n] == target
        assert getattr(tu, n).__module__ == "xsdba_tpu_torch." + target.lstrip("."), n
    with pytest.raises(AttributeError):
        tu.not_a_name


def test_operators_and_seasons():
    assert tu.OPERATORS.keys() == ju.OPERATORS.keys()
    for op in ju.OPERATORS:
        assert tu.get_op(op)(1, 2) == ju.get_op(op)(1, 2) and tu.get_op(op)(2, 2) == ju.get_op(op)(2, 2)
    with pytest.raises(ValueError, match="not recognized"):
        tu.get_op("~")
    assert tu.SEASON_MAP == ju.SEASON_MAP
    np.testing.assert_array_equal(tu.map_season_to_int(np.array(["DJF", "SON", "JJA"])), ju.map_season_to_int(np.array(["DJF", "SON", "JJA"])))


@pytest.mark.parametrize("cyclic", [True, False])
@pytest.mark.parametrize("tensor", [False, True])
def test_add_cyclic_bounds(cyclic, tensor):
    x = np.arange(24.0).reshape(2, 12)
    want = ju.add_cyclic_bounds(xt.DataArray(x, ("site", "month"), {"month": np.arange(1, 13)}, {}, "x"), "month", cyclic_coords=cyclic)
    got = tu.add_cyclic_bounds(xp.DataArray(torch.from_numpy(x) if tensor else x, ("site", "month"), {"month": np.arange(1, 13)}, {}, "x"), "month", cyclic_coords=cyclic)
    assert isinstance(got.data, torch.Tensor) == tensor and got.dims == want.dims
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(got.coords["month"], want.coords["month"])


def test_ensure_longest_doy():
    rng = np.random.default_rng(1)
    a, b = rng.normal(0, 1, 365), rng.normal(0, 1, 360)
    out = {}
    for mod, helpers in ((xt, ju), (xp, tu)):
        ga = mod.DataArray(a, ("dayofyear",), {"dayofyear": np.arange(1, 366)}, {}, "a")
        gb = mod.DataArray(b, ("dayofyear",), {"dayofyear": np.arange(1, 361)}, {}, "b")
        diff = helpers.ensure_longest_doy(lambda x, y: _np(x) - _np(y))
        with pytest.warns(UserWarning, match="longest range"):
            out[mod] = diff(ga, gb)
    assert out[xp].shape == (365,)
    np.testing.assert_array_equal(out[xp], out[xt])


def test_ecdf_map_cdf_and_map_cdf_1d():
    rng = np.random.default_rng(2)
    x, y = rng.normal(0, 1, (3, 400)), rng.gamma(2, 2, (3, 400))
    x[1, :20] = np.nan
    t = lambda mod, a, nm: mod.DataArray(a, ("site", "time"), {"time": mod.date_range("2000-01-01", periods=400, freq="D")}, {}, nm)  # noqa: E731
    for value in (0.3, -1.0):
        want, got = ju.ecdf(t(xt, x, "x"), value), tu.ecdf(t(xp, x, "x"), value)
        assert got.dims == want.dims == ("site",) and got.attrs == want.attrs
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12, atol=0)
        np.testing.assert_allclose(_np(tu.ecdf(x, value)), _np(ju.ecdf(x, value)), rtol=1e-12, atol=0)
    want = ju.map_cdf(xt.Dataset({"x": t(xt, x, "x"), "y": t(xt, y, "y")}), y_value=[1.0, 4.0, 9.0])
    got = tu.map_cdf(xp.Dataset({"x": t(xp, x, "x"), "y": t(xp, y, "y")}), y_value=[1.0, 4.0, 9.0])
    assert got.dims == want.dims == ("site", "x")
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12, atol=1e-12)
    assert tu.map_cdf_1d(x[0], y[0], 4.0) == ju.map_cdf_1d(x[0], y[0], 4.0)
    assert tu.map_cdf_1d(torch.from_numpy(x[0]), y[0], 4.0) == ju.map_cdf_1d(x[0], y[0], 4.0)


def test_get_clusters_1d():
    rng = np.random.default_rng(3)
    x = rng.gamma(1, 2, 500)
    x[[10, 200]] = np.nan
    for data, u1, u2 in ((x, 6.0, 1.5), (np.array([0.0, 3, 3, 0, 1, 5, 1, 0, 2, 0]), 4, 0.5), (np.zeros(5), 1, 0.5)):
        for g, w in zip(tu.get_clusters_1d(data, u1, u2), ju.get_clusters_1d(data, u1, u2)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tu.get_clusters_1d(torch.from_numpy(x), 6.0, 1.5)[0], ju.get_clusters_1d(x, 6.0, 1.5)[0])


def test_random_tiebreak(monkeypatch):
    """Given the reference's draws: the reference's result.  On the port's
    stream: ties broken, the order of distinct values kept, the noise within
    [0.1, 0.25] of the smallest gap, and a seed replays it."""
    rng = np.random.default_rng(0)
    x = np.round(rng.normal(0, 1, (2, 200)), 1)
    da = lambda mod: mod.DataArray(x, ("site", "time"), {"time": mod.date_range("2000-01-01", periods=200, freq="D")}, {}, "x")  # noqa: E731
    trng.seed(3)
    a = _np(tu.random_tiebreak(da(xp)))
    trng.seed(3)
    np.testing.assert_array_equal(_np(tu.random_tiebreak(da(xp))), a)
    assert a.dtype == np.float64 and all(len(np.unique(r)) == 200 for r in a)
    gap = 0.1
    assert ((a - x) >= 0.1 * gap - 1e-12).all() and ((a - x) <= 0.25 * gap + 1e-12).all()
    order = np.argsort(x, axis=-1, kind="stable")
    assert (np.diff(np.take_along_axis(x, order, -1)) >= 0).all()
    reference_noise(monkeypatch)
    jax_seed(JAX_SEED)
    want = _np(ju.random_tiebreak(da(xt)))
    jax_seed(JAX_SEED)
    np.testing.assert_array_equal(_np(tu.random_tiebreak(da(xp))), want)


def test_rand_rot_matrix():
    """An integer draws ``ops/rotation.py``'s matrices; a coordinate gives
    the reference's labelled float32 form, orthogonal (Haar over O(n), as
    the reference draws; both packages' draws differ: C4)."""
    m = tu.rand_rot_matrix(4, num=3, dtype=torch.float64)
    assert m.shape == (3, 4, 4)
    np.testing.assert_allclose(_np(m @ m.transpose(-1, -2)), np.broadcast_to(np.eye(4), (3, 4, 4)), atol=1e-12)
    crd = lambda mod: mod.DataArray(np.array(["a", "b", "c"]), ("multivar",), {}, {}, "multivar")  # noqa: E731
    for num in (1, 2):
        want, got = ju.rand_rot_matrix(crd(xt), num=num), tu.rand_rot_matrix(crd(xp), num=num)
        assert got.dims == want.dims and got.attrs == want.attrs and got.name == want.name
        assert _np(got).dtype == np.float32 == _np(want).dtype
        np.testing.assert_array_equal(got.coords["multivar_prime"], want.coords["multivar_prime"])
        g = _np(got).reshape(-1, 3, 3)
        np.testing.assert_allclose(g @ g.transpose(0, 2, 1), np.broadcast_to(np.eye(3), g.shape), atol=1e-6)
        np.testing.assert_allclose(np.abs(np.linalg.det(g)), 1.0, atol=1e-5)


def test_copy_all_attrs():
    for mod, helpers in ((xt, ju), (xp, tu)):
        a = mod.DataArray(np.arange(3.0), ("x",), {}, {"units": "K"}, "a")
        ds = mod.Dataset({"a": a})
        ref = mod.Dataset({"a": a.copy(attrs={"units": "K", "long_name": "temp"})})
        ref.attrs["global"] = 1
        helpers.copy_all_attrs(ds, ref)
        assert ds.attrs["global"] == 1 and ds["a"].attrs["long_name"] == "temp"
