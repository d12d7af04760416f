"""``Scaling`` and ``LOCI`` of the port against the JAX package, on the CPU.

The adjust cores are held under ``==``.  The reference runs them compiled,
where XLA's CPU backend contracts the group blend to
``fma(1 - w, v0, w * v1)`` and LOCI's ``fac * (sim - sth) + thresh`` to one
fused multiply-add; the port rounds both once for these callers
(``broadcast_groups_core(fused=True)``, ``ops/cuda/fma_kernel.py:fma``).
Handed the reference's trained factors (through a saved file, which crosses
the packages), every adjusted series equals the reference's bit for bit.

The trained factors themselves are group means: sums of up to a thousand
members that XLA and PyTorch add in different orders, and for ``kind="*"``
XLA rewrites the ratio of two means ``(s_r / n_r) / (s_h / n_h)`` into
``(s_r * n_h) / (n_r * s_h)``.  They are held at 1e-12 (float64) and 2e-6
(float32), and so is the series adjusted with the port's own factors.
"""

import os

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from e2e_cases import build_inputs


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


FROZEN = os.path.join(os.path.dirname(__file__), "golden", "e2e_scen.npz")
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12, equal_nan=True), np.float32: dict(rtol=2e-6, atol=2e-6, equal_nan=True)}
N = 365 * 3
GROUPS = ["time.month", "time.dayofyear", "time", "time.season"]
DTYPES = [np.float64, np.float32]


def _series(mod, values, start, dims=("site", "time")):
    t = mod.date_range(start, periods=values.shape[dims.index("time")], freq="D", calendar="noleap")
    return mod.DataArray(values, dims, {"time": t}, {"units": "mm/d"}, "pr")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    ref, hist, sim = (rng.gamma(2, 2, (3, N)) for _ in range(3))
    hist[1, 30:40] = np.nan
    sim[2, 5] = np.nan
    return ref, hist, sim


def _both(data, dtype):
    ref, hist, sim = (a.astype(dtype) for a in data)
    mk = lambda mod: (_series(mod, ref, "1991-01-01"), _series(mod, hist, "1991-01-01"), _series(mod, sim, "2051-01-01"))  # noqa: E731
    return mk(xt), mk(xp)


def _np(da):
    return da.data.numpy() if isinstance(da.data, torch.Tensor) else np.asarray(da.data)


def _carried(tmp_path, trained, cls):
    """The reference's trained object, saved and loaded by the port."""
    path = str(tmp_path / "trained")
    trained.save(path)
    loaded = getattr(xp, cls).from_file(path)
    assert type(loaded) is getattr(xp, cls)
    return loaded


@pytest.mark.parametrize("interp", ["nearest", "linear"])
@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_scaling(tmp_path, data, dtype, group, kind, interp):
    (jr, jh, js), (tr, th, ts) = _both(data, dtype)
    want = xt.Scaling.train(jr, jh, group=group, kind=kind)
    got = xp.Scaling.train(tr, th, group=group, kind=kind)
    assert got.ds["af"].dims == want.ds["af"].dims and got.kind == kind and got.group == xp.Grouper(group)
    np.testing.assert_allclose(_np(got.ds["af"]), np.asarray(want.ds["af"].data), **TOL[dtype])
    scen_w = want.adjust(js, interp=interp)
    scen = got.adjust(ts, interp=interp)
    assert scen.dims == scen_w.dims and scen.attrs["units"] == scen_w.attrs["units"] and _np(scen).dtype == dtype
    np.testing.assert_allclose(_np(scen), np.asarray(scen_w.data), **TOL[dtype])
    # the reference's factors through the port's adjust: bit for bit
    np.testing.assert_array_equal(_np(_carried(tmp_path, want, "Scaling").adjust(ts, interp=interp)), np.asarray(scen_w.data))


@pytest.mark.parametrize("interp", ["nearest", "linear"])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_loci(tmp_path, data, dtype, group, interp):
    (jr, jh, js), (tr, th, ts) = _both(data, dtype)
    want = xt.LOCI.train(jr, jh, group=group, thresh="1 mm/d")
    got = xp.LOCI.train(tr, th, group=group, thresh="1 mm/d")
    assert got.thresh == want.thresh == 1.0
    # the threshold quantile is an order statistic's lerp, rounded as the reference rounds it
    np.testing.assert_array_equal(_np(got.ds["hist_thresh"]), np.asarray(want.ds["hist_thresh"].data))
    np.testing.assert_allclose(_np(got.ds["af"]), np.asarray(want.ds["af"].data), **TOL[dtype])
    assert got.ds["hist_thresh"].attrs["units"] == "mm/d"
    scen_w = want.adjust(js, interp=interp)
    scen = got.adjust(ts, interp=interp)
    assert scen.dims == scen_w.dims and _np(scen).dtype == dtype and np.nanmin(_np(scen)) >= 0
    # float32: the factor's 2e-6 times (sim - threshold), values up to 30
    np.testing.assert_allclose(_np(scen), np.asarray(scen_w.data), **(TOL[dtype] if dtype is np.float64 else dict(rtol=2e-5, atol=2e-5, equal_nan=True)))
    np.testing.assert_array_equal(_np(_carried(tmp_path, want, "LOCI").adjust(ts, interp=interp)), np.asarray(scen_w.data))


def test_defaults_are_nearest_for_scaling_and_linear_for_loci(data):
    _, (tr, th, ts) = _both(data, np.float64)
    sc = xp.Scaling.train(tr, th, group="time.month")
    np.testing.assert_array_equal(_np(sc.adjust(ts)), _np(sc.adjust(ts, interp="nearest")))
    assert (_np(sc.adjust(ts)) != _np(sc.adjust(ts, interp="linear"))).any()
    lo = xp.LOCI.train(tr, th, group="time.month", thresh="1 mm/d")
    np.testing.assert_array_equal(_np(lo.adjust(ts)), _np(lo.adjust(ts, interp="linear")))


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_unfused_blend_is_not_the_reference(tmp_path, data, dtype):
    """What ``fused=True`` repairs: with every operation of the blend rounded
    (the form the eager caller, EQM's tail mask, keeps) the monthly linear
    Scaling adjust is an ulp away from the reference in some values."""
    from xsdba_tpu_torch.models import _algos
    from xsdba_tpu_torch.models._wrap import device_brackets

    (jr, jh, js), (_, _, ts) = _both(data, dtype)
    want = xt.Scaling.train(jr, jh, group="time.month", kind="+")
    scen_w = np.asarray(want.adjust(js, interp="linear").data)
    af = torch.as_tensor(np.array(want.ds["af"].data))
    sim = torch.as_tensor(np.asarray(ts.data))
    brackets = device_brackets(xp.Grouper("time.month").indexes(ts.time), "linear")
    fused = sim + _algos.broadcast_groups_core(af, brackets, fused=True)
    plain = sim + _algos.broadcast_groups_core(af, brackets)
    np.testing.assert_array_equal(fused.numpy(), scen_w)
    np.testing.assert_array_equal(_algos.scaling_adjust_core(sim, af, brackets, kind="+").numpy(), scen_w)
    differ = int((plain.numpy() != scen_w).sum())
    assert differ > 0
    torch.testing.assert_close(plain, fused, rtol=1e-12 if dtype is np.float64 else 2e-6, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_eqm_tail_mask_keeps_the_eager_rounding(dtype):
    """``broadcast_groups_core``'s other caller, EQM's ``max_tail_factor``
    mask, runs eagerly in the reference: unfused there and here, and
    ``scen`` stays equal bit for bit."""
    d = build_inputs()
    cast = lambda mod, da: mod.DataArray(  # noqa: E731
        np.asarray(da.data, dtype), da.dims,
        {"time": mod.date_range(f"{int(da.coords['time'].year[0])}-01-01", periods=da.shape[-1], freq="D", calendar="noleap")},
        dict(da.attrs), da.name,
    )
    kw = dict(group="time.month", nquantiles=10, kind="*", max_tail_factor=1.2)
    want = xt.EmpiricalQuantileMapping.train(cast(xt, d["ref"]), cast(xt, d["hist"]), **kw).adjust(cast(xt, d["sim"]), interp="linear")
    got = xp.EmpiricalQuantileMapping.train(cast(xp, d["ref"]), cast(xp, d["hist"]), **kw).adjust(cast(xp, d["sim"]), interp="linear")
    np.testing.assert_array_equal(_np(got), np.asarray(want.data))
    assert (np.asarray(want.data) == np.asarray(d["sim"].data, dtype)).any()     # the mask did skip some values


@pytest.mark.parametrize("cls,kw", [("Scaling", dict(kind="*")), ("LOCI", dict(thresh="1 mm/d"))])
def test_add_dims_pool_the_training(data, cls, kw):
    """``add_dims=["site"]``: one factor a group, trained on all sites."""
    (jr, jh, js), (tr, th, ts) = _both(data, np.float64)
    want = getattr(xt, cls).train(jr, jh, group=xt.Grouper("time.month", add_dims=["site"]), **kw)
    got = getattr(xp, cls).train(tr, th, group=xp.Grouper("time.month", add_dims=["site"]), **kw)
    assert got.ds["af"].dims == want.ds["af"].dims == ("month",)
    np.testing.assert_allclose(_np(got.ds["af"]), np.asarray(want.ds["af"].data), **TOL[np.float64])
    np.testing.assert_allclose(_np(got.adjust(ts)), np.asarray(want.adjust(js).data), **TOL[np.float64])


def test_dim_order_is_kept(data):
    ref, hist, sim = data
    tr, th, ts = (_series(xp, a.T.copy(), s, ("time", "site")) for a, s in ((ref, "1991-01-01"), (hist, "1991-01-01"), (sim, "2051-01-01")))
    scen = xp.Scaling.train(tr, th, group="time.month").adjust(ts)
    assert scen.dims == ("time", "site")
    _, (r2, h2, s2) = _both(data, np.float64)
    np.testing.assert_array_equal(_np(scen).T, _np(xp.Scaling.train(r2, h2, group="time.month").adjust(s2)))


def _port_da(da):
    t = da.coords["time"]
    time = xp.date_range(f"{int(t.year[0]):04d}-{int(t.month[0]):02d}-{int(t.day[0]):02d}", periods=len(t), freq="D", calendar=t.calendar)
    return xp.DataArray(torch.as_tensor(np.asarray(da.data)), da.dims, {"time": time}, dict(da.attrs), da.name)


def test_e2e_cases_match_frozen():
    """The ``Scaling`` and ``LOCI`` cases of ``tests/e2e_cases.py`` replayed
    through the port against the frozen reference outputs."""
    frozen = np.load(FROZEN)
    d = {k: _port_da(v) for k, v in build_inputs().items() if k in ("ref", "hist", "sim")}
    scen = xp.Scaling.train(d["ref"], d["hist"], kind="*", group="time.month").adjust(d["sim"])
    np.testing.assert_allclose(_np(scen), frozen["Scaling"], rtol=1e-12, atol=1e-12)
    scen = xp.LOCI.train(d["ref"], d["hist"], thresh="1 mm/d").adjust(d["sim"])
    np.testing.assert_allclose(_np(scen), frozen["LOCI"], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cls,kw", [("Scaling", dict(kind="*", group="time.month")), ("LOCI", dict(thresh="1 mm/d", group="time.month"))])
def test_port_files_load_in_the_reference(tmp_path, data, cls, kw):
    (_, _, js), (tr, th, ts) = _both(data, np.float64)
    trained = getattr(xp, cls).train(tr, th, **kw)
    path = str(tmp_path / "port")
    trained.save(path)
    back = getattr(xt, cls).from_file(path)
    np.testing.assert_array_equal(np.asarray(back.adjust(js, interp="linear").data), _np(trained.adjust(ts, interp="linear")))
