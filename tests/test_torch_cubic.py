"""Cubic interpolation (``interp="cubic"``) of the port against the JAX
package and scipy, on the CPU.

The port's spline is ``xsdba_tpu_torch/ops/interp.py``'s ``_cubic_slopes``
(the not-a-knot system, solved by Thomas elimination over the node axis)
and ``_eval_cubic_segment`` (the Hermite form), the JAX package's
``_cubic_slopes`` / ``_eval_cubic_segment``.  The JAX package always
reaches them inside a compiled program (the adjust cores and the npdft
cores carry ``jax.jit``), where XLA's CPU backend contracts some of the
products into fused multiply-adds and rewrites ``(a / b) / c`` as
``a / (b * c)``; the port rounds those places once too (``fma``).

Tolerances.  The lookup itself equals the JAX package's compiled lookup
under ``==`` in float64 and float32, and so does every public EQM / QDM
``scen`` (monthly, seasonal, ``group="time"`` and dayofyear + 31).  The
spline matches scipy's ``interp1d(kind="cubic")`` at 1e-9 (float64), as the
JAX package's own tests hold it.  DQM's public ``scen`` carries its trends,
which XLA and PyTorch sum in other orders (``tests/test_torch_dqm.py``):
float64 at 1e-10, its QM step through EQM's ``==``.  The npdft transforms
rotate by a V x V product XLA sums in its own order
(``tests/test_torch_npdft.py``): float64 at 1e-10.  ``mode="reference"``
runs scipy's ``CloughTocher2DInterpolator`` on the host in both packages:
1e-12.
"""

import numpy as np
import pytest
import torch
from scipy.interpolate import interp1d

import jax
import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu.ops import interp as J
from xsdba_tpu.ops.rotation import rand_rot_matrix
from xsdba_tpu.utils.rng import seed as jax_seed
from xsdba_tpu_torch.ops import interp as T


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


DTYPES = [np.float64, np.float32]
_jit_lookup = jax.jit(J.interp1d_table, static_argnames=("method", "extrap"))


def _scipy_cubic(v, xq, yq, extrap="constant"):
    bad = np.isnan(xq) | np.isnan(yq)
    xs, ys = xq[~bad], yq[~bad]
    fill = (ys[0], ys[-1]) if extrap == "constant" else np.nan
    out = np.full(v.shape, np.nan)
    ok = ~np.isnan(v)
    out[ok] = interp1d(xs, ys, kind="cubic", bounds_error=False, fill_value=fill)(v[ok])
    return out


def _both(v, xq, yq, extrap="constant", method="cubic"):
    """(port, JAX package compiled) lookups of the same numpy inputs."""
    got = T.interp1d_table(torch.from_numpy(v), torch.from_numpy(xq), torch.from_numpy(yq), method, extrap).numpy()
    return got, np.asarray(_jit_lookup(v, xq, yq, method=method, extrap=extrap))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("extrap", ["constant", "nan"])
@pytest.mark.parametrize("nq", [4, 8, 50, 100])  # 100 > the unroll limit: the JAX package's gathered form
def test_cubic_lookup_matches_reference_and_scipy(nq, extrap, dtype):
    rng = np.random.default_rng(nq)
    xq = np.sort(rng.normal(0, 5, nq))
    yq = rng.normal(10, 3, nq)
    v = rng.normal(0, 6.5, 400)  # in- and out-of-range points
    v[::37] = np.nan
    got, want = _both(v.astype(dtype), xq.astype(dtype), yq.astype(dtype), extrap)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    if dtype is np.float64:
        np.testing.assert_allclose(got, _scipy_cubic(v, xq, yq, extrap), atol=1e-9, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cubic_nan_pair_compaction(dtype):
    """NaN (x, y) pairs are dropped before the solve, as the reference
    hands scipy the masked table."""
    rng = np.random.default_rng(5)
    xq = np.sort(rng.normal(0, 5, 24))
    yq = rng.normal(0, 3, 24)
    xq[[3, 11]] = np.nan
    yq[17] = np.nan
    v = rng.normal(0, 6, 300)
    got, want = _both(v.astype(dtype), xq.astype(dtype), yq.astype(dtype))
    np.testing.assert_array_equal(got, want)
    if dtype is np.float64:
        np.testing.assert_allclose(got, _scipy_cubic(v, xq, yq), atol=1e-9, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cubic_batched_tables_variable_nvalid(dtype):
    rng = np.random.default_rng(6)
    B, nq = 6, 30
    xq = np.sort(rng.normal(0, 5, (B, nq)), axis=-1)
    yq = rng.normal(0, 3, (B, nq))
    xq[1, 5:9] = np.nan
    yq[2, -3:] = np.nan
    xq[3, 4:] = np.nan  # four valid nodes: the smallest spline
    xq[4] = np.nan      # an empty table: NaN
    v = rng.normal(0, 6, (B, 200))
    got, want = _both(v.astype(dtype), xq.astype(dtype), yq.astype(dtype), "nan")
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[4]).all()
    if dtype is np.float64:
        for i in (0, 1, 2, 3, 5):
            np.testing.assert_allclose(got[i], _scipy_cubic(v[i], xq[i], yq[i], "nan"), atol=1e-9, rtol=0, err_msg=f"row {i}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_cubic_degenerate_rows(dtype):
    """ROADMAP C5: where scipy raises, the lookup does not.  A table of fewer
    than 4 valid nodes degrades to linear, and duplicated nodes carry NaN
    slopes through the division: the same NaN pattern and values as the JAX
    package."""
    xq = np.array([[0.0, 1.0, 2.0, np.nan, np.nan, np.nan], [0.0, 1.0, 1.0, 2.0, 3.0, 4.0], [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]])
    yq = np.array([[0.0, 3.0, 1.0, np.nan, np.nan, np.nan], [0.0, 3.0, 1.0, 2.0, 0.5, 1.0], [1.0, 3.0, 1.0, 2.0, 0.5, 1.0]])
    v = np.tile(np.array([-0.5, 0.25, 0.5, 1.0, 1.5, 2.5, 3.7, 6.0]), (3, 1))
    got, want = _both(v.astype(dtype), xq.astype(dtype), yq.astype(dtype))
    np.testing.assert_array_equal(got, want)
    lin, _ = _both(v.astype(dtype), xq.astype(dtype), yq.astype(dtype), method="linear")
    np.testing.assert_array_equal(got[0], lin[0])
    assert np.isnan(got[1, 1:-1]).all() and np.isfinite(got[2]).all()


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gathered_form_equals_unrolled(dtype, method):
    """The gathered form, which every cubic lookup and every table above
    the unroll limit takes, and the unrolled form agree bit for bit on the
    methods both serve (with NaN values, NaN pairs, short and empty tables,
    values on the nodes and beyond both ends)."""
    rng = np.random.default_rng(9)
    B, nq = 8, 50
    xq = np.sort(rng.normal(0, 3, (B, nq)), axis=-1)
    yq = rng.normal(0, 1, (B, nq))
    xq[1, 10:14] = np.nan
    xq[2, 3:] = np.nan
    xq[3] = np.nan
    v = rng.normal(0, 4, (B, 500))
    v[:, :5] = xq[:, :5]
    v[:, 7] = np.nan
    xs, ys, nv = T._compact_nan_pairs(torch.from_numpy(xq.astype(dtype)), torch.from_numpy(yq.astype(dtype)))
    vt = torch.from_numpy(v.astype(dtype))
    for extrap in ("constant", "nan"):
        a = T._interp_unrolled(vt, xs, ys, nv, method, extrap).numpy()
        b = T._interp_gathered(vt, xs, ys, nv, method, extrap).numpy()
        np.testing.assert_array_equal(a, b)


def _series(dtype, S=2, Y=4):
    """ref, hist, sim [site, time] of each package: a seasonal cycle with
    a shift, a wider spread in hist and a warmer sim."""
    rng = np.random.default_rng(1)
    n = 365 * Y
    season = 4 * np.sin(2 * np.pi * np.arange(n) / 365)
    arrays = (10 + season + rng.normal(0, 2, (S, n)), 12 + 1.2 * season + rng.normal(0, 2.5, (S, n)), 13 + season + rng.normal(0, 2.5, (S, n)))
    out = {}
    for mod in (xt, xp):
        t = mod.date_range("1991-01-01", periods=n, freq="D", calendar="noleap")
        out[mod] = [mod.DataArray(a.astype(dtype), ("site", "time"), {"time": t}, {"units": "K"}, "tas") for a in arrays]
    return out


def _np(da):
    return da.data.numpy() if isinstance(da.data, torch.Tensor) else np.asarray(da.data)


GROUPS = ["time.month", "time.season", "time", ("time.dayofyear", 31)]


def _adjusted(cls, dtype, group, **adjust_kw):
    data = _series(dtype)
    out = {}
    for mod in (xt, xp):
        g = mod.Grouper(*group) if isinstance(group, tuple) else group
        obj = getattr(mod, cls).train(data[mod][0], data[mod][1], group=g, nquantiles=15, kind="+")
        out[mod] = _np(obj.adjust(data[mod][2], interp="cubic", **adjust_kw))
    return out[xp], out[xt]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", GROUPS, ids=lambda g: g if isinstance(g, str) else "doy31")
@pytest.mark.parametrize("cls", ["EmpiricalQuantileMapping", "QuantileDeltaMapping"])
def test_public_cubic_scen_equals_reference(cls, group, dtype):
    """Grouped (the cyclic blend of two groups' splines), seasonal,
    ``group="time"`` and windowed dayofyear (collapsed brackets): the cubic
    lookup runs on every route and ``scen`` equals the reference's."""
    got, want = _adjusted(cls, dtype, group)
    assert got.dtype == dtype and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("group", GROUPS, ids=lambda g: g if isinstance(g, str) else "doy31")
def test_dqm_cubic_matches_reference(group):
    got, want = _adjusted("DetrendedQuantileMapping", np.float64, group, detrend=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_cubic_differs_from_linear_and_fits_scipy_per_group():
    """EQM at ``group="time"``: the factor lookup is scipy's cubic spline of
    the (hist_q -> af) table, and not the linear one."""
    data = _series(np.float64, S=1)[xp]
    eqm = xp.EmpiricalQuantileMapping.train(data[0], data[1], group="time", nquantiles=30)
    v = _np(data[2])[0]
    scen = _np(eqm.adjust(data[2], interp="cubic"))[0]
    want = v + _scipy_cubic(v, _np(eqm.ds["hist_q"])[0, 0], _np(eqm.ds["af"])[0, 0])
    np.testing.assert_allclose(scen, want, atol=1e-9, rtol=0)
    assert np.abs(_np(eqm.adjust(data[2], interp="linear"))[0] - want).max() > 1e-8


def test_reference_mode_cubic():
    """``mode="reference"`` with cubic: scipy's Clough-Tocher interpolant
    over the (value, group) points, on the host in both packages."""
    got, want = _adjusted("EmpiricalQuantileMapping", np.float64, "time.month", mode="reference")
    assert np.isfinite(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, equal_nan=True)


@pytest.fixture(scope="module")
def rots():
    jax_seed(11)
    return np.array(rand_rot_matrix(3, num=3, dtype=np.float64))


def _mv(mod, seed, start="1981-01-01"):
    rng = np.random.default_rng(seed)
    x = rng.normal(10, 3, (2, 3, 365 * 2))
    x[:, 1] += 0.5 * x[:, 0]
    t = mod.date_range(start, periods=x.shape[-1], freq="D", calendar="noleap")
    return mod.DataArray(x, ("site", "multivar", "time"), {"time": t, "multivar": np.array(["a", "b", "c"])}, {"units": ""}, "d")


def test_npdf_transform_and_mbcn_cubic(rots):
    """The multivariate schemes with ``interp="cubic"``: every rotation's
    factor lookup (and MBCn's per-block QDM) is the cubic spline."""
    out = {}
    for mod in (xt, xp):
        npdf = mod.NpdfTransform.adjust(_mv(mod, 1), _mv(mod, 2), _mv(mod, 3, "2041-01-01"), base_kws={"nquantiles": 8},
                                        adj_kws={"interp": "cubic"}, n_iter=3, n_escore=-1, rot_matrices=rots)
        mbcn = mod.MBCn.train(_mv(mod, 1), _mv(mod, 2), base_kws={"nquantiles": 8}, adj_kws={"interp": "cubic"},
                              n_iter=3, n_escore=-1, rot_matrices=rots)
        out[mod] = _np(npdf), _np(mbcn.ds["af_q"]), _np(mbcn.adjust(_mv(mod, 3, "2041-01-01"), _mv(mod, 1), _mv(mod, 2)))
    for got, want in zip(out[xp], out[xt]):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
