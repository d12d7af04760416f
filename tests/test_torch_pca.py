"""The port's principal-component transform and ``PrincipalComponents``
against the JAX package, on the CPU.

The same seeded numpy inputs go through both packages.  The PC matrices'
columns each carry an arbitrary sign (``jnp.linalg.svd(hermitian=True)`` and
``torch.linalg.eigh`` need not agree), which the 2^M orientation search
cancels: so the transform, the centroids and ``scen`` are compared, and of R
only ``R Rᵀ``.  float64 at 1e-12 (the transforms) and 1e-10 (``scen``),
float32 at a relative 2e-5 (the eigensolvers' rounding).
"""

import os

import jax
import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from e2e_cases import build_inputs
from xsdba_tpu.ops import pca as jp
from xsdba_tpu_torch.ops import pca as tp


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


FROZEN = os.path.join(os.path.dirname(__file__), "golden", "e2e_scen.npz")
TOL = {np.float64: dict(rtol=0, atol=1e-12), np.float32: dict(rtol=2e-5, atol=2e-5)}


def _t(a, dtype=np.float64):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _np(x):
    return x.data.numpy() if isinstance(x, xp.DataArray) else x.numpy()


def _blocks(M=3, P=200):
    """ref / hist blocks [batch 4, group 2, M, P] with NaN points."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(4, 2, M, M))
    ref = np.einsum("...ij,...jp->...ip", A, rng.normal(size=(4, 2, M, P))) + 5
    hist = 1.3 * ref + rng.normal(0, 0.3, ref.shape) + 1
    hist[0, 0, 1, 10:20] = np.nan
    ref[1, 1, :, 50] = np.nan
    return ref, hist


def test_sign_vectors_equal_reference():
    for m in (1, 2, 3, 4):
        np.testing.assert_array_equal(tp._sign_vectors(m), jp._sign_vectors(m))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pc_matrix_spans_the_same_covariance(dtype):
    ref, _ = _blocks()
    want = np.asarray(jp.pc_matrix(ref.astype(dtype)))
    got = tp.pc_matrix(_t(ref, dtype)).numpy()
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2), want @ np.swapaxes(want, -1, -2), **TOL[dtype])
    # columns in descending order of their norms (the eigenvalues' roots)
    norms = np.linalg.norm(got, axis=-2)
    assert (np.diff(norms, axis=-1) <= 1e-6 * norms[..., :1]).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("orientation", ["simple", "full"])
def test_pc_transform_matrix_matches_reference(dtype, orientation):
    ref, hist = (a.astype(dtype) for a in _blocks())
    want = jp.pc_transform_matrix(ref, hist, best_orientation=orientation)
    got = tp.pc_transform_matrix(_t(ref, dtype), _t(hist, dtype), best_orientation=orientation)
    for name, w, g in zip(("trans", "ref_mean", "hist_mean"), want, got):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL[dtype])


def test_orientation_searches_pick_the_reference_signs():
    ref, hist = _blocks()
    R, H = jp.pc_matrix(ref), jp.pc_matrix(hist)
    Hinv = np.linalg.inv(np.asarray(H))
    R = np.asarray(R)
    np.testing.assert_array_equal(tp.best_pc_orientation_simple(_t(R), _t(Hinv)).numpy(), np.asarray(jax.jit(jp.best_pc_orientation_simple)(R, Hinv)))
    rm, hm = np.nanmean(ref, axis=-1), np.nanmean(hist, axis=-1)
    np.testing.assert_array_equal(
        tp.best_pc_orientation_full(_t(R), _t(Hinv), _t(rm), _t(hm), _t(hist)).numpy(),
        np.asarray(jax.jit(jp.best_pc_orientation_full)(R, Hinv, rm, hm, hist)),
    )


def test_unknown_orientation_raises():
    ref, hist = _blocks()
    with pytest.raises(ValueError, match="best_orientation"):
        tp.pc_transform_matrix(_t(ref), _t(hist), best_orientation="other")


@pytest.mark.parametrize("shape", [(40, 7), (7, 40)])
def test_first_eof_pattern_matches_reference(shape):
    rng = np.random.default_rng(6)
    anom = rng.normal(size=(2,) + shape) @ np.diag(np.linspace(3, 1, shape[1]))
    anom[0, 3, 2] = np.nan
    anom[1, :, 4] = np.nan            # a site with no finite value
    w_eof, w_var = (np.asarray(a) for a in jp.first_eof_pattern(anom))
    g_eof, g_var = (a.numpy() for a in tp.first_eof_pattern(_t(anom)))
    np.testing.assert_allclose(g_eof, w_eof, rtol=0, atol=1e-10, equal_nan=True)
    np.testing.assert_allclose(g_var, w_var, rtol=0, atol=1e-12)


# --------------------------------------------------------------- public API


def _mv(mod, seed, dims=("site", "multivar", "time"), T=730, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(10, 3, (2, 3, T))
    x[:, 1] += 0.5 * x[:, 0]
    x[:, 2] = 0.3 * x[:, 2] + 0.2 * x[:, 1] * seed
    t = mod.date_range("1981-01-01", periods=T, freq="D", calendar="noleap")
    coords = {"time": t, "multivar": np.array(["tas", "pr", "wind"]), "site": np.arange(2)}
    da = mod.DataArray(x.astype(dtype), ("site", "multivar", "time"), coords, {"units": ""}, "x")
    return da.transpose(*dims) if dims != da.dims else da


def _port(da):
    t = da.coords["time"]
    time = xp.date_range(f"{int(t.year[0]):04d}-{int(t.month[0]):02d}-{int(t.day[0]):02d}", periods=len(t), freq="D", calendar=t.calendar)
    coords = {"time": time, **{k: np.asarray(v) for k, v in da.coords.items() if k != "time"}}
    return xp.DataArray(torch.as_tensor(np.array(da.data)), da.dims, coords, dict(da.attrs), da.name)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("group,orientation,dims", [
    ("time", "simple", ("site", "multivar", "time")),
    ("time.month", "full", ("site", "multivar", "time")),
    ("time.season", "simple", ("time", "site", "multivar")),
])
def test_public_api_matches_reference(dtype, group, orientation, dims):
    ref, hist, sim = (_mv(xt, s, dims, dtype=dtype) for s in (1, 2, 3))
    want = xt.PrincipalComponents.train(ref, hist, crd_dim="multivar", group=group, best_orientation=orientation)
    got = xp.PrincipalComponents.train(_port(ref), _port(hist), crd_dim="multivar", group=group, best_orientation=orientation)
    for k in ("trans", "ref_mean", "hist_mean"):
        assert got.ds[k].dims == want.ds[k].dims, k
        np.testing.assert_allclose(_np(got.ds[k]), np.asarray(want.ds[k].data), err_msg=k, **TOL[dtype])
    sw = want.adjust(sim)
    sg = got.adjust(_port(sim))
    assert sg.dims == sw.dims == sim.dims and isinstance(sg.data, torch.Tensor)
    tol = dict(rtol=0, atol=1e-10) if dtype == np.float64 else dict(rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(_np(sg), np.asarray(sw.data), **tol)


def test_unknown_orientation_raises_in_train():
    with pytest.raises(ValueError, match="best_orientation"):
        xp.PrincipalComponents.train(_port(_mv(xt, 1)), _port(_mv(xt, 2)), crd_dim="multivar", best_orientation="other")


def test_files_cross_the_packages(tmp_path):
    ref, hist, sim = (_mv(xt, s) for s in (1, 2, 3))
    want = xt.PrincipalComponents.train(ref, hist, crd_dim="multivar", group="time.month")
    scen_want = np.asarray(want.adjust(sim).data)
    want.save(tmp_path / "ref_trained")
    loaded = xp.PrincipalComponents.from_file(tmp_path / "ref_trained")
    assert type(loaded) is xp.PrincipalComponents and loaded.group.name == "time.month"
    np.testing.assert_allclose(_np(loaded.adjust(_port(sim))), scen_want, rtol=0, atol=1e-10)
    xp.PrincipalComponents.train(_port(ref), _port(hist), crd_dim="multivar", group="time.month").save(tmp_path / "port_trained")
    back = xt.PrincipalComponents.from_file(tmp_path / "port_trained")
    np.testing.assert_allclose(np.asarray(back.adjust(sim).data), scen_want, rtol=0, atol=1e-10)


def test_e2e_case_matches_frozen():
    """The ``PrincipalComponents`` case of ``tests/e2e_cases.py`` replayed
    through the port."""
    d = {k: _port(v) for k, v in build_inputs().items() if k.startswith("mv_")}
    scen = xp.PrincipalComponents.train(d["mv_ref"], d["mv_hist"], crd_dim="multivar").adjust(d["mv_hist"])
    np.testing.assert_allclose(_np(scen), np.load(FROZEN)["PrincipalComponents"], rtol=1e-9, atol=1e-9)
