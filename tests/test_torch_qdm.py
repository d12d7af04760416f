"""The port's QDM/EQM main path against the JAX package, on the CPU.

The fused ``qdm_train_adjust_core`` step and the public
``EmpiricalQuantileMapping`` / ``QuantileDeltaMapping`` classes run on the
same numpy inputs through both packages.  The fused step and the adjusted
series of the public cases equal the reference bit for bit (the port rounds
the quantile lerp, the lookup and the bracket blend once, as XLA's CPU
backend contracts them in the reference's compiled programs).  Trained
tables are held at 1e-12 in float64 (the frozen end-to-end values too) and
rtol = atol = 2e-6 in float32: the reference computes ``hist_q_raw`` outside
its compiled programs, unfused, an ulp away (ROADMAP C11).
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


def _fused_step_both(n_sites, n_years, dtype, kind):
    """(port, reference) outputs of the fused QDM step on
    ``__graft_entry__._example_problem(n_sites, n_years)``."""
    from functools import partial

    from __graft_entry__ import _example_problem
    from xsdba_tpu.models._algos import qdm_train_adjust_core as jcore
    from xsdba_tpu_torch.models._algos import qdm_train_adjust_core
    from xsdba_tpu_torch.models._wrap import device_brackets

    args = _example_problem(n_sites=n_sites, n_years=n_years, dtype=dtype)
    want = np.asarray(partial(jcore, kind=kind, interp="linear", extrapolation="constant")(*args))
    ref, hist, sim, gather_idx, group_idx, scatter_slot, q = (np.array(a) for a in args[:6] + (args[7],))
    t = xp.date_range("2000-01-01", periods=365 * n_years, freq="D", calendar="noleap")
    gi = xp.Grouper("time.month").indexes(t)
    np.testing.assert_array_equal(gi.gather_idx, gather_idx)
    got = qdm_train_adjust_core(
        torch.as_tensor(ref), torch.as_tensor(hist), torch.as_tensor(sim),
        torch.as_tensor(gather_idx), torch.as_tensor(group_idx), torch.as_tensor(scatter_slot),
        device_brackets(gi, "linear"), torch.as_tensor(q),
        kind=kind, interp="linear", extrapolation="constant",
    )
    assert got.dtype == torch.from_numpy(ref).dtype and got.shape == ref.shape
    return got.numpy(), want


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_qdm_train_adjust_core(dtype):
    """The headline step at ``__graft_entry__._example_problem(8, 5)``, bit
    for bit."""
    got, want = _fused_step_both(8, 5, dtype, "+")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_sites,n_years", [(8, 5), (16, 10)])
@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_qdm_step_equals_reference_bitwise(dtype, kind, n_sites, n_years):
    """Both kinds, both dtypes, two sizes: no output differs from the
    reference's compiled step (the bracket blend rounded once, ROADMAP
    C10)."""
    got, want = _fused_step_both(n_sites, n_years, dtype, kind)
    np.testing.assert_array_equal(got, want)


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


def _ref_da(da, dtype):
    return xt.DataArray(np.asarray(da.data, dtype), da.dims, dict(da.coords), dict(da.attrs), da.name)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("cls,train_kw,adjust_kw", [c for c in ADJUST_CASES if c[2].get("mode") != "reference"])
def test_public_api_scen_equals_reference_bitwise(e2e, cls, train_kw, adjust_kw, dtype):
    """Every public case that adjusts through the port's own lookup (the
    monthly linear ones through ``interp_grouped_partitioned`` and its fused
    blend): the adjusted series equals the reference's under ``==``, in both
    dtypes."""
    ref, hist, sim = (_ref_da(e2e[k], dtype) for k in ("ref", "hist", "sim"))
    want = getattr(xt, cls).train(ref, hist, **train_kw).adjust(sim, **adjust_kw)
    got = getattr(xp, cls).train(_port_da(ref, dtype), _port_da(hist, dtype), **train_kw).adjust(_port_da(sim, dtype), **adjust_kw)
    assert got.data.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


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


# -------------------------------------------------- dry-day preprocessing


def reference_draws(monkeypatch):
    """Make the port's preprocessing draw what the JAX package draws: each
    jitter or frequency adaptation takes the JAX stream's next key and
    splits it as the JAX package's cores do (``torch.Generator`` cannot
    reproduce Threefry, ROADMAP C4).  Seed the JAX stream before each
    package's call."""
    import jax

    from xsdba_tpu.utils.rng import next_key
    from xsdba_tpu_torch import processing
    from xsdba_tpu_torch.utils.tensor import numpy_dtype

    def uniform(key, x, lo, hi):
        return torch.from_numpy(np.array(jax.random.uniform(key, tuple(x.shape), dtype=numpy_dtype(x.dtype), minval=lo, maxval=hi)))

    def jitter_draws(x, lower, upper, lower_bnd, upper_bnd):
        key = next_key()
        under = over = None
        if lower is not None:
            k1, key = jax.random.split(key)
            under = uniform(k1, x, lower_bnd, lower)
        if upper is not None:
            over = uniform(jax.random.split(key)[0], x, upper, upper_bnd)
        return under, over

    def adapt_freq_draws(simg):
        k1, k2 = jax.random.split(next_key())
        return uniform(k1, simg, 0.1, 0.25), uniform(k2, simg, 0.0, 1.0)

    monkeypatch.setattr(processing, "_jitter_draws", jitter_draws)
    monkeypatch.setattr(processing, "_adapt_freq_draws", adapt_freq_draws)


@pytest.mark.parametrize("cls", ["EmpiricalQuantileMapping", "QuantileDeltaMapping"])
@pytest.mark.parametrize("train_kw", [
    dict(jitter_under_thresh_value="0.1 mm/d"),
    dict(adapt_freq_thresh="3 mm/d"),
    dict(jitter_over_thresh_value="10 mm/d", jitter_over_thresh_upper_bnd="20 mm/d"),
], ids=["jitter_under", "adapt_freq", "jitter_over"])
def test_preprocessing_matches_reference(monkeypatch, e2e, cls, train_kw):
    """Training with jitter or frequency adaptation (and adjusting, which
    adapts sim with the trained P0 and pth), the port drawing the
    reference's draws for the same seed: the trained tables at 1e-12 and
    ``scen`` under ``==``."""
    from e2e_cases import JAX_SEED
    from xsdba_tpu.utils.rng import seed as jax_seed

    reference_draws(monkeypatch)
    kw = dict(train_kw, group="time.month", nquantiles=10, kind="*")
    out = {}
    for mod, conv in ((xt, lambda da: da), (xp, _port_da)):
        jax_seed(JAX_SEED)
        trained = getattr(mod, cls).train(conv(e2e["ref"]), conv(e2e["hist"]), **kw)
        out[mod] = trained, trained.adjust(conv(e2e["sim"]), interp="linear")
    for name in out[xt][0].ds.data_vars:
        np.testing.assert_allclose(_np(out[xp][0].ds[name]), _np(out[xt][0].ds[name]), **F64)
    np.testing.assert_array_equal(_np(out[xp][1]), _np(out[xt][1]))


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
