"""The port's QDM/EQM main path against the JAX package, on the CPU.

The fused ``qdm_train_adjust_core`` step and the public
``EmpiricalQuantileMapping`` / ``QuantileDeltaMapping`` classes run on the
same numpy inputs through both packages.  float64 within 1e-12 (the frozen
end-to-end values are held at 1e-12 too); float32 within rtol = atol = 2e-6
(XLA's CPU FMA contraction).
"""

import os

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from e2e_cases import build_inputs

FROZEN = os.path.join(os.path.dirname(__file__), "golden", "e2e_scen.npz")
F64 = dict(rtol=1e-12, atol=1e-12, equal_nan=True)
F32 = dict(rtol=2e-6, atol=2e-6, equal_nan=True)


def _port_da(da, dtype=None, start=None):
    """A reference DataArray as the port's: same values, dims, attrs and a
    time axis built from the same calendar."""
    t = da.coords["time"]
    start = start or f"{int(t.year[0]):04d}-{int(t.month[0]):02d}-{int(t.day[0]):02d}"
    time = xp.date_range(start, periods=len(t), freq="D", calendar=t.calendar)
    data = torch.as_tensor(np.asarray(da.data, dtype=dtype))
    return xp.DataArray(data, da.dims, {"time": time}, dict(da.attrs), da.name)


@pytest.fixture(scope="module")
def e2e():
    d = build_inputs()
    return {k: d[k] for k in ("ref", "hist", "sim")}


@pytest.fixture(scope="module")
def e2e_port(e2e):
    return {k: _port_da(v) for k, v in e2e.items()}


def _np(da):
    return np.asarray(da.data.numpy() if isinstance(da.data, torch.Tensor) else da.data, dtype=np.float64)


# ------------------------------------------------------------- fused step


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_qdm_train_adjust_core(dtype):
    """The headline step at ``__graft_entry__._example_problem(8, 5)``."""
    from functools import partial

    from __graft_entry__ import _example_problem
    from xsdba_tpu.models._algos import qdm_train_adjust_core as jcore
    from xsdba_tpu_torch.models._algos import qdm_train_adjust_core
    from xsdba_tpu_torch.models._wrap import device_brackets

    args = _example_problem(n_sites=8, n_years=5, dtype=dtype)
    want = np.asarray(partial(jcore, kind="+", interp="linear", extrapolation="constant")(*args))
    ref, hist, sim, gather_idx, group_idx, scatter_slot, q = (np.array(a) for a in args[:6] + (args[7],))
    t = xp.date_range("2000-01-01", periods=365 * 5, freq="D", calendar="noleap")
    gi = xp.Grouper("time.month").indexes(t)
    np.testing.assert_array_equal(gi.gather_idx, gather_idx)
    got = qdm_train_adjust_core(
        torch.as_tensor(ref), torch.as_tensor(hist), torch.as_tensor(sim),
        torch.as_tensor(gather_idx), torch.as_tensor(group_idx), torch.as_tensor(scatter_slot),
        device_brackets(gi, "linear"), torch.as_tensor(q),
        kind="+", interp="linear", extrapolation="constant",
    )
    assert got.dtype == torch.from_numpy(ref).dtype and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), want, **(F64 if dtype == np.float64 else F32))


# ------------------------------------------------------------- public API


def test_e2e_cases_match_frozen(e2e_port):
    """The ``tests/e2e_cases.py`` EQM and QDM cases, replayed through the
    port's containers, against the frozen reference outputs."""
    frozen = np.load(FROZEN)
    d = e2e_port
    eqm = xp.EmpiricalQuantileMapping.train(d["ref"], d["hist"], kind="*", group="time.month", nquantiles=20)
    scen = eqm.adjust(d["sim"], interp="linear")
    assert isinstance(scen.data, torch.Tensor) and scen.data.dtype == torch.float64
    np.testing.assert_allclose(_np(scen), frozen["EmpiricalQuantileMapping"], **F64)
    qdm = xp.QuantileDeltaMapping.train(d["ref"], d["hist"], kind="*", group="time.month", nquantiles=15)
    np.testing.assert_allclose(_np(qdm.adjust(d["sim"])), frozen["QuantileDeltaMapping"], **F64)


ADJUST_CASES = [
    ("QuantileDeltaMapping", dict(group="time.month", nquantiles=15, kind="*"), dict(interp="linear")),
    ("QuantileDeltaMapping", dict(group="time.season", nquantiles=10, kind="+"), dict(interp="nearest")),
    ("QuantileDeltaMapping", dict(group="time", nquantiles=12, kind="+"), dict(interp="linear", extrapolation="nan")),
    ("QuantileDeltaMapping", dict(group="time.month", nquantiles=15, kind="*"), dict(interp="linear", mode="reference")),
    ("EmpiricalQuantileMapping", dict(group="time.month", nquantiles=20, kind="+"), dict(interp="linear", mode="reference")),
    ("EmpiricalQuantileMapping", dict(group="time.season", nquantiles=8, kind="*"), dict(interp="nearest", extrapolation="nan")),
    ("EmpiricalQuantileMapping", dict(group="time.month", nquantiles=10, kind="*", max_tail_factor=1.2), dict(interp="linear")),
    ("EmpiricalQuantileMapping", dict(group="time", nquantiles=np.linspace(0.05, 0.95, 7), kind="+"), dict(interp="linear")),
    ("QuantileDeltaMapping", dict(group="time.month", add_dims=["site"], nquantiles=10, kind="+"), dict(interp="linear")),
]


@pytest.mark.parametrize("cls,train_kw,adjust_kw", ADJUST_CASES)
def test_public_api_matches_reference(e2e, e2e_port, cls, train_kw, adjust_kw):
    want = getattr(xt, cls).train(e2e["ref"], e2e["hist"], **train_kw)
    got = getattr(xp, cls).train(e2e_port["ref"], e2e_port["hist"], **train_kw)
    for name in want.ds.data_vars:
        np.testing.assert_allclose(_np(got.ds[name]), _np(want.ds[name]), **F64)
        assert got.ds[name].dims == want.ds[name].dims
    sw = want.adjust(e2e["sim"], **adjust_kw)
    sg = got.adjust(e2e_port["sim"], **adjust_kw)
    assert sg.dims == sw.dims and sg.attrs["units"] == sw.attrs["units"]
    np.testing.assert_allclose(_np(sg), _np(sw), **F64)


def test_float32_public_path_keeps_dtype_and_device(e2e, e2e_port):
    """f32 data stays f32 on its device; quantile nodes follow the data."""
    ref, hist, sim = (_port_da(e2e[k], np.float32) for k in ("ref", "hist", "sim"))
    qdm = xp.QuantileDeltaMapping.train(ref, hist, kind="+", group="time.month", nquantiles=50)
    assert qdm.ds["af"].data.dtype == torch.float32
    assert qdm.ds["af"].coords["quantiles"].dtype == np.float32
    scen = qdm.adjust(sim, interp="linear")
    assert scen.data.dtype == torch.float32 and scen.data.device.type == "cpu"
    want = xt.QuantileDeltaMapping.train(
        *(xt.DataArray(np.asarray(e2e[k].data, np.float32), e2e[k].dims, dict(e2e[k].coords), dict(e2e[k].attrs), e2e[k].name) for k in ("ref", "hist")),
        kind="+", group="time.month", nquantiles=50,
    ).adjust(xt.DataArray(np.asarray(e2e["sim"].data, np.float32), e2e["sim"].dims, dict(e2e["sim"].coords), dict(e2e["sim"].attrs), "sim"), interp="linear")
    np.testing.assert_allclose(scen.data.numpy(), np.asarray(want.data), **F32)


def test_extra_output_returns_sim_q(e2e, e2e_port):
    with xt.set_options(extra_output=True):
        want = xt.QuantileDeltaMapping.train(e2e["ref"], e2e["hist"], group="time.month", nquantiles=15).adjust(e2e["sim"], interp="linear")
    with xp.set_options(extra_output=True):
        got = xp.QuantileDeltaMapping.train(e2e_port["ref"], e2e_port["hist"], group="time.month", nquantiles=15).adjust(e2e_port["sim"], interp="linear")
    for name in ("scen", "sim_q"):
        np.testing.assert_allclose(_np(got[name]), _np(want[name]), **F64)


# ---------------------------------------------------- carrying parameters


@pytest.mark.parametrize("cls", ["QuantileDeltaMapping", "EmpiricalQuantileMapping"])
def test_trained_by_reference_loads_in_port(tmp_path, e2e, e2e_port, cls):
    """An object trained and saved by ``xsdba_tpu`` loads in the port (file
    and ``from_params``) and adjusts to the same ``scen``; a file the port
    saves loads back in the reference."""
    trained = getattr(xt, cls).train(e2e["ref"], e2e["hist"], kind="*", group="time.month", nquantiles=15)
    want = _np(trained.adjust(e2e["sim"], interp="linear"))
    path = str(tmp_path / "trained")
    trained.save(path)

    loaded = getattr(xp, cls).from_file(path)
    assert type(loaded) is getattr(xp, cls) and loaded.kind == "*" and loaded.group == xp.Grouper("time.month")
    np.testing.assert_allclose(_np(loaded.adjust(e2e_port["sim"], interp="linear")), want, **F64)

    built = getattr(xp, cls).from_params(
        np.asarray(trained.ds["af"].data), np.asarray(trained.ds["hist_q"].data),
        np.asarray(trained.ds["af"].coords["quantiles"]), group="time.month", kind="*", train_units="mm/d",
    )
    scen = built.adjust(e2e_port["sim"], interp="linear")
    assert scen.attrs["units"] == "mm/d"
    np.testing.assert_allclose(_np(scen), want, **F64)

    back = str(tmp_path / "back")
    loaded.save(back)
    np.testing.assert_allclose(_np(getattr(xt, cls).from_file(back).adjust(e2e["sim"], interp="linear")), want, **F64)


# ---------------------------------------------------------- not yet ported


@pytest.mark.parametrize("train_kw,adjust_kw,item", [
    (dict(jitter_under_thresh_value="0.1 mm/d"), None, "A7"),
    (dict(adapt_freq_thresh="0.1 mm/d"), None, "A7"),
    (dict(jitter_over_thresh_value="1 mm/d", jitter_over_thresh_upper_bnd="10 mm/d"), None, "A7"),
    (dict(group="time.month"), dict(interp="cubic"), "A7"),
])
def test_unported_options_raise(e2e_port, train_kw, adjust_kw, item):
    d = e2e_port
    with pytest.raises(NotImplementedError, match=item):
        obj = xp.EmpiricalQuantileMapping.train(d["ref"], d["hist"], nquantiles=10, **train_kw)
        obj.adjust(d["sim"], **adjust_kw)


def test_chip_smoke_main_path_on_cpu():
    """``chip_smoke.py``'s main-path phase, on the CPU at a small size: the
    port's public QDM path on its data recipe against the reference's."""
    from chip_smoke import NQ, example_problem, run_main_path

    t, (ref, hist, sim) = example_problem(4, 3)
    got = run_main_path(*(torch.from_numpy(a) for a in (ref, hist, sim)), t)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    tj = xt.date_range("2000-01-01", periods=len(t), freq="D", calendar="noleap")
    mk = lambda x: xt.DataArray(x, ("site", "time"), {"time": tj}, {"units": "K"})  # noqa: E731
    want = xt.QuantileDeltaMapping.train(mk(ref), mk(hist), group="time.month", nquantiles=NQ, kind="+").adjust(mk(sim), interp="linear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want.data), **F32)


@pytest.mark.parametrize("kind", ["+", "*"])
def test_eqm_train_core_on_gathered_groups(kind):
    """The train core that takes already-gathered [..., G, L] group rows."""
    from xsdba_tpu.models._algos import eqm_train_core as jcore
    from xsdba_tpu_torch.models._algos import eqm_train_core

    rng = np.random.default_rng(11)
    refg, histg = (rng.gamma(2, 2, (3, 12, 40)) for _ in range(2))
    histg[0, 1, 5:] = np.nan
    q = np.linspace(0.05, 0.95, 10)
    want = jcore(refg, histg, q, kind=kind)
    got = eqm_train_core(torch.as_tensor(refg), torch.as_tensor(histg), torch.as_tensor(q), kind=kind)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
