"""The port's windowed quantile engine and windowed EQM against the JAX
package, on the CPU.

``windowed_group_quantile`` runs the same numpy inputs through both packages,
with both packages pinned to their merge engines (``selection_backend=False``,
the CPU's default being the selection engine), and through the port's re-sort
oracle
``grouped_nan_quantile``: noleap (regular slab layout) and standard
(gathered slab, edge groups) calendars, NaN gaps (the dynamic extraction),
all-NaN sites (the static extraction's mask) and windows on both sides of
the shared fold's threshold of 9.  Tolerances: float64 within 1e-12;
float32 within rtol = atol = 2e-6, which covers the few-ulp gamma
difference between the static extraction's numpy arithmetic and the
oracle's device arithmetic (ROADMAP C2).
"""

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu.models import _algos as jalgos
from xsdba_tpu.ops.quantile import windowed_group_quantile as jwgq
from xsdba_tpu_torch.models import _algos as palgos
from xsdba_tpu_torch.models._wrap import device_brackets
from xsdba_tpu_torch.ops import quantile as pq
from xsdba_tpu_torch.ops.correction import equally_spaced_nodes


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask
    for the CPU, and pin the port to its merge engine (the CPU's default is
    the selection engine, ``tests/test_torch_selquant.py``)."""
    with xp.set_options(device="cpu", selection_backend=False):
        yield


F64 = dict(rtol=1e-12, atol=1e-12, equal_nan=True)
F32 = dict(rtol=2e-6, atol=2e-6, equal_nan=True)
TOL = {np.float64: F64, np.float32: F32}


def _times(calendar, years, start="2001-01-01"):
    kw = dict(periods=365 * years, freq="D", calendar=calendar)
    return xt.date_range(start, **kw), xp.date_range(start, **kw)


def _series(n_sites, T, seed, nan=None):
    x = np.random.default_rng(seed).normal(10, 3, (n_sites, T))
    if nan in ("gaps", "both"):
        x[0, 100:200] = np.nan
        x[1, np.random.default_rng(seed + 1).random(T) < 0.02] = np.nan
    if nan in ("ocean", "both"):
        x[-1] = np.nan
    return x


QUANTILE_CASES = [
    # group, window, calendar, NaN pattern, static extraction expected
    ("time.dayofyear", 31, "noleap", None, True),
    ("time.dayofyear", 31, "standard", "both", False),
    ("time.dayofyear", 11, "noleap", "ocean", True),
    ("time.dayofyear", 11, "noleap", "gaps", False),
    ("time.dayofyear", 5, "standard", None, True),
    ("5D", 3, "noleap", "ocean", True),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("group,window,calendar,nan,static", QUANTILE_CASES)
def test_windowed_group_quantile_matches_reference(group, window, calendar, nan, static, dtype):
    tj, tp = _times(calendar, 6)
    gj = xt.Grouper(group, window=window).indexes(tj)
    gp = xp.Grouper(group, window=window).indexes(tp)
    plan = gp.merge_plan
    assert plan is not None and (plan.regular_period is not None) == (calendar == "noleap" and group != "5D")
    x = _series(3, len(tp), seed=window, nan=nan).astype(dtype)
    q = equally_spaced_nodes(20).astype(dtype)
    assert pq._static_safe(torch.as_tensor(x)) == static

    got = pq.windowed_group_quantile(torch.as_tensor(x), plan, q)
    assert got.dtype == torch.from_numpy(x).dtype and tuple(got.shape) == (3, gp.n_groups, 20)
    with xt.set_options(selection_backend=False):
        want = np.asarray(jwgq(x, gj.merge_plan, q))
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    oracle = pq.grouped_nan_quantile(torch.as_tensor(x), gp.gather_idx, torch.as_tensor(q))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL[dtype])
    if nan in ("ocean", "both"):
        assert bool(torch.isnan(got[-1]).all())


def test_windowed_quantile_chunks_agree(monkeypatch):
    """The chunk bound on the merged intermediate splits the batch; each
    chunk decides nothing on its own (one finiteness check for all)."""
    _, tp = _times("standard", 4)
    plan = xp.Grouper("time.dayofyear", window=15).indexes(tp).merge_plan
    x = torch.as_tensor(_series(5, len(tp), seed=3, nan="both"))
    q = equally_spaced_nodes(9)
    whole = pq.windowed_group_quantile(x, plan, q)
    monkeypatch.setattr(pq, "_windowed_max_chunk", lambda plan: 2)
    chunked = pq.windowed_group_quantile(x.reshape(5, 1, -1), plan, q)
    assert tuple(chunked.shape) == (5, 1) + tuple(whole.shape[1:])
    np.testing.assert_array_equal(chunked[:, 0].numpy(), whole.numpy())


# ------------------------------------------------------------- fused cores


@pytest.mark.parametrize("group,window,nan", [("time.dayofyear", 31, None), ("time.dayofyear", 31, "gaps"), ("5D", 3, "ocean")])
def test_fused_train_adjust_matches_reference(group, window, nan):
    """``eqm_train_adjust_windowed`` against the reference's, and against
    the port's own train-then-adjust sequence; ``assume_finite=False`` pins
    the dynamic extraction, which must agree."""
    tj, tp = _times("noleap", 4)
    gj = xt.Grouper(group, window=window).indexes(tj)
    gp = xp.Grouper(group, window=window).indexes(tp)
    ref, hist, sim = (_series(3, len(tp), seed=s, nan=nan if s == 1 else None) for s in (1, 2, 3))
    q = equally_spaced_nodes(15)
    br = device_brackets(gp, "linear")
    got = palgos.eqm_train_adjust_windowed(*(torch.as_tensor(a) for a in (ref, hist, sim)), gp.merge_plan, q, br, kind="+")
    from xsdba_tpu.models._wrap import device_brackets as jbrackets

    with xt.set_options(selection_backend=False):
        want = jalgos.eqm_train_adjust_windowed(ref, hist, sim, gj.merge_plan, q, jbrackets(gj, "linear"), kind="+")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
    af, hq = palgos.eqm_train_windowed(torch.as_tensor(ref), torch.as_tensor(hist), gp.merge_plan, q, kind="+")
    scen = palgos.qm_adjust_core(torch.as_tensor(sim), hq, af, br, kind="+", interp="linear", extrapolation="constant")
    np.testing.assert_array_equal(scen.numpy(), got[0].numpy())
    dyn = palgos.eqm_train_adjust_windowed(*(torch.as_tensor(a) for a in (ref, hist, sim)), gp.merge_plan, q, br, kind="+", assume_finite=False)
    np.testing.assert_allclose(dyn[0].numpy(), got[0].numpy(), **F64)


def test_train_of_unmatched_pair():
    """ref and hist of different dtypes take one engine pass each."""
    _, tp = _times("noleap", 4)
    plan = xp.Grouper("time.dayofyear", window=9).indexes(tp).merge_plan
    ref = torch.as_tensor(_series(2, len(tp), seed=4))
    hist = torch.as_tensor(_series(2, len(tp), seed=5)).to(torch.float32)
    q = equally_spaced_nodes(10)
    af, hq = palgos.eqm_train_windowed(ref, hist, plan, q, kind="+")
    want_h = pq.windowed_group_quantile(hist, plan, q)
    np.testing.assert_array_equal(hq.numpy(), want_h.numpy())
    assert af.shape == hq.shape


# ------------------------------------------------------------- public API


def _pair(x, tj, tp, dims=("site", "time"), name="tas"):
    attrs = {"units": "K"}
    return (xt.DataArray(x, dims, {"time": tj}, attrs, name), xp.DataArray(torch.as_tensor(x), dims, {"time": tp}, dict(attrs), name))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_public_windowed_eqm_matches_reference(dtype):
    """The whole slice: ``EmpiricalQuantileMapping.train(group=
    "time.dayofyear", window=31).adjust(interp="linear")`` at 3 sites x 6
    noleap years."""
    tj, tp = _times("noleap", 6)
    data = [_series(3, len(tp), seed=s).astype(dtype) + off for s, off in ((11, 0.0), (12, 2.0), (13, 3.0))]
    (rj, rp), (hj, hp), (sj, sp) = (_pair(a, tj, tp) for a in data)
    kw = dict(group="time.dayofyear", window=31, nquantiles=20)
    with xt.set_options(selection_backend=False):
        want = xt.EmpiricalQuantileMapping.train(rj, hj, **kw)
        scen_w = want.adjust(sj, interp="linear")
    got = xp.EmpiricalQuantileMapping.train(rp, hp, **kw)
    scen_g = got.adjust(sp, interp="linear")
    assert got.group == xp.Grouper("time.dayofyear", window=31)
    for name in ("af", "hist_q"):
        assert got.ds[name].dims == want.ds[name].dims == ("site", "dayofyear", "quantiles")
        assert got.ds[name].data.dtype == torch.from_numpy(data[0]).dtype
        np.testing.assert_allclose(got.ds[name].data.numpy(), np.asarray(want.ds[name].data), **TOL[dtype])
    assert scen_g.dims == scen_w.dims and scen_g.data.dtype == torch.from_numpy(data[0]).dtype
    np.testing.assert_allclose(scen_g.data.numpy(), np.asarray(scen_w.data), **TOL[dtype])


@pytest.mark.filterwarnings("ignore:Using dayofyear grouping on a standard calendar")
@pytest.mark.parametrize("cls,train_kw,adjust_kw", [
    ("EmpiricalQuantileMapping", dict(group=xt.Grouper("time.dayofyear", window=15, add_dims=["site"]), nquantiles=12, kind="*"), dict(interp="nearest")),
    ("QuantileDeltaMapping", dict(group="time.dayofyear", window=31, nquantiles=15, kind="+"), dict(interp="linear", rank_window=False)),
    ("EmpiricalQuantileMapping", dict(group="time.dayofyear", window=7, nquantiles=10, kind="+", max_tail_factor=1.5), dict(interp="linear")),
])
def test_public_windowed_variants_match_reference(cls, train_kw, adjust_kw):
    """Pooled ``add_dims`` training (no regular layout, no host counts:
    the dynamic extraction), windowed QDM, and ``max_tail_factor`` on a
    standard calendar."""
    tj, tp = _times("standard", 4, start="2000-03-01")
    data = [np.abs(_series(3, len(tp), seed=s, nan="gaps" if s == 21 else None)) + 1.0 for s in (21, 22, 23)]
    (rj, rp), (hj, hp), (sj, sp) = (_pair(a, tj, tp) for a in data)
    pkw = dict(train_kw)
    if isinstance(pkw["group"], xt.Grouper):
        gr = pkw["group"]
        pkw["group"] = xp.Grouper(gr.name, window=gr.window, add_dims=gr.add_dims)
    with xt.set_options(selection_backend=False):
        want = getattr(xt, cls).train(rj, hj, **train_kw)
        scen_w = want.adjust(sj, **adjust_kw)
    got = getattr(xp, cls).train(rp, hp, **pkw)
    for name in want.ds.data_vars:
        np.testing.assert_allclose(got.ds[name].data.numpy(), np.asarray(want.ds[name].data), **F64)
    np.testing.assert_allclose(got.adjust(sp, **adjust_kw).data.numpy(), np.asarray(scen_w.data), **F64)


def test_windowed_eqm_trained_by_reference_loads_in_port(tmp_path):
    """A windowed EQM trained and saved by ``xsdba_tpu`` loads in the port
    with its grouping and adjusts to the same ``scen``."""
    tj, tp = _times("noleap", 4)
    data = [_series(2, len(tp), seed=s) for s in (31, 32, 33)]
    (rj, _), (hj, _), (sj, sp) = (_pair(a, tj, tp) for a in data)
    trained = xt.EmpiricalQuantileMapping.train(rj, hj, group="time.dayofyear", window=31, nquantiles=20, kind="*")
    path = str(tmp_path / "eqm_doy31")
    trained.save(path)
    loaded = xp.EmpiricalQuantileMapping.from_file(path)
    assert loaded.group == xp.Grouper("time.dayofyear", window=31) and loaded.kind == "*"
    np.testing.assert_allclose(
        loaded.adjust(sp, interp="linear").data.numpy(), np.asarray(trained.adjust(sj, interp="linear").data), **F64
    )


def test_chip_smoke_heavy_path_on_cpu():
    """``chip_smoke.py``'s heavy phase, on the CPU at a small size: the
    port's public windowed EQM (merge engine) on the heavy data recipe
    against the reference's and the re-sort oracle, and in float64 against
    the oracle (as on the card)."""
    from chip_smoke import NQ, heavy_problem, resort_oracle, run_windowed_path

    t, (ref, hist, sim) = heavy_problem(3, 4)
    got = run_windowed_path(*(torch.from_numpy(a) for a in (ref, hist, sim)), t)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    tj = xt.date_range("1950-01-01", periods=len(t), freq="D", calendar="noleap")
    mk = lambda x: xt.DataArray(x, ("site", "time"), {"time": tj}, {"units": "K"})  # noqa: E731
    with xt.set_options(selection_backend=False):
        want = xt.EmpiricalQuantileMapping.train(mk(ref), mk(hist), group="time.dayofyear", window=31, nquantiles=NQ, kind="+")
        want = want.adjust(mk(sim), interp="linear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want.data), **F32)
    data64 = [torch.from_numpy(a).double() for a in (ref, hist, sim)]
    np.testing.assert_allclose(run_windowed_path(*data64, t).numpy(), resort_oracle(*data64, t).numpy(), **F64)
    oracle = resort_oracle(*(torch.from_numpy(a) for a in (ref, hist, sim)), t)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **F32)
