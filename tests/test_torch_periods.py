"""``processing.stack_periods`` / ``unstack_periods`` of the port against the
JAX package, on the CPU.

The windows are found on the host from the calendar in both packages, and
the data is only moved, so everything is held under ``==``: the stacked
array (NaN padding included), the period labels, the stored parameters, the
placeholder time axis, and the unstacked series, which equals the input
wherever a window covers it.  MBCn's ``period_dim`` is driven through the
ported ``stack_periods`` (the JAX package's own test of it does the same).
"""

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu.ops.rotation import rand_rot_matrix
from xsdba_tpu.utils.rng import seed as jax_seed


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


def _np(da):
    return da.data.numpy() if isinstance(da.data, torch.Tensor) else np.asarray(da.data)


def _series(mod, n, calendar="noleap", start="2000-01-01", freq="D", sites=2):
    t = mod.date_range(start, periods=n, freq=freq, calendar=calendar)
    x = np.arange(float(n))[None] + 1000.0 * np.arange(sites)[:, None]
    return mod.DataArray(x, ("site", "time"), {"time": t, "site": np.arange(sites)}, {"units": "K"}, "x")


def _same_time(a, b):
    """Two packages' time indexes hold the same dates in the same calendar."""
    assert a.calendar == b.calendar
    for f in ("year", "month", "day"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


CASES = [
    # (series kwargs, stack kwargs)
    (dict(n=365 * 50 + 13), dict(window=30, stride=10)),
    (dict(n=365 * 12), dict(window=5)),
    (dict(n=360 * 8, calendar="360_day"), dict(window=6, stride=2, freq="QS")),
    (dict(n=360 * 5, calendar="360_day"), dict(window=9, stride=3, freq="MS")),
    (dict(n=100), dict(window=30, stride=10, freq="D")),
    (dict(n=365 * 12), dict(window=5, stride=5, freq="YS", min_length=2)),
    (dict(n=365 * 6, start="2000-02-01"), dict(window=2, stride=2, freq="YS")),
    (dict(n=365 * 10, calendar="standard"), dict(window=2, freq="YS", align_days=False)),
    (dict(n=12 * 20, freq="MS"), dict(window=6, stride=2, freq="YS")),
    (dict(n=360 * 6, calendar="360_day"), dict(window=4, stride=4, freq="QS-DEC", align_days=False)),
    (dict(n=365 * 8 + 2, start="2000-01-03"), dict(window=2, stride=2, freq="YE-JUN")),
    (dict(n=360 * 6, calendar="360_day"), dict(window=2, stride=2, freq="QE-DEC")),
    (dict(n=360 * 6, calendar="360_day"), dict(window=3, stride=3, freq="ME")),
    (dict(n=365 * 9, start="2000-03-01"), dict(window=3, stride=1, freq="2YS-MAR")),
]


@pytest.mark.parametrize("series_kw,stack_kw", CASES, ids=lambda v: "-".join(f"{k}={v}" for k, v in v.items()))
def test_stack_unstack_match_reference(series_kw, stack_kw):
    j, t = _series(xt, **series_kw), _series(xp, **series_kw)
    want, got = xt.processing.stack_periods(j, **stack_kw), xp.processing.stack_periods(t, **stack_kw)
    assert got.dims == want.dims == ("site", "period", "time")
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(got.coords["period"], want.coords["period"])
    _same_time(got.time, want.time)
    gp, wp = got.attrs["_stack_periods"], want.attrs["_stack_periods"]
    assert {k: v for k, v in gp.items() if k != "time_ymd"} == {k: v for k, v in wp.items() if k != "time_ymd"}
    stride = stack_kw.get("stride") or stack_kw["window"]
    if (stack_kw["window"] / stride) % 2 != 1:
        with pytest.raises(NotImplementedError, match="odd number"):
            xp.processing.unstack_periods(got)
        return
    back_w, back_g = xt.processing.unstack_periods(want), xp.processing.unstack_periods(got)
    assert back_g.dims == ("site", "time") and back_g.time == t.time
    _same_time(back_g.time, back_w.time)
    np.testing.assert_array_equal(_np(back_g), _np(back_w))
    covered = ~np.isnan(_np(back_g))
    np.testing.assert_array_equal(_np(back_g)[covered], _np(t)[covered])


def test_round_trip_covers_whole_windows():
    """30-year windows moved by a decade over 150 years (the moving-window
    adjustment of a scenario): 13 periods, and stack then unstack gives the
    series back everywhere."""
    t = _series(xp, 365 * 150, start="1951-01-01")
    st = xp.processing.stack_periods(t, window=30, stride=10)
    assert tuple(st.shape) == (2, 13, 365 * 30)
    np.testing.assert_array_equal(_np(xp.processing.unstack_periods(st)), _np(t))


def test_refusals():
    da = _series(xp, 365 * 10, calendar="standard")
    with pytest.raises(ValueError, match="Stride must be less"):
        xp.processing.stack_periods(da, window=2, stride=3)
    with pytest.raises(ValueError, match="unaligned day-of-year"):
        xp.processing.stack_periods(da, window=2, freq="YS")
    with pytest.raises(ValueError, match="unaligned day-of-month"):
        xp.processing.stack_periods(_series(xp, 365 * 10), window=2, freq="QS")
    with pytest.raises(ValueError, match="No complete periods"):
        xp.processing.stack_periods(_series(xp, 365 * 3), window=5)
    with pytest.raises(ValueError, match="stack_periods"):
        xp.processing.unstack_periods(da)


def test_mbcn_period_dim_through_stack_periods():
    """MBCn adjusting a long sim stacked into 4-year periods, with the first
    ref-length slice of each period kept (ROADMAP A7.2): the port's scen
    equals the reference's at 1e-10 (float64, the MBCn tolerance of
    ``tests/test_torch_mbcn.py``), and each period equals its own adjustment."""
    n_hist, n_sim = 365 * 4, 365 * 12
    rng = np.random.default_rng(3)
    arrays = (rng.normal(0, 1, (2, n_hist)), rng.normal(1, 1.3, (2, n_hist)), rng.normal(1.5, 1.2, (2, n_sim)))
    jax_seed(11)
    rots = np.array(rand_rot_matrix(2, num=2, dtype=np.float64))
    out = {}
    for mod in (xt, xp):
        mv = np.array(["a", "b"])
        mk = lambda a, start: mod.DataArray(  # noqa: E731
            a, ("multivar", "time"), {"time": mod.date_range(start, periods=a.shape[-1], freq="D", calendar="noleap"), "multivar": mv}, {"units": ""}, "d"
        )
        ref, hist, sim_long = mk(arrays[0], "1981-01-01"), mk(arrays[1], "1981-01-01"), mk(arrays[2], "2010-01-01")
        sim = mod.processing.stack_periods(sim_long, window=4, stride=4).isel(time=np.arange(n_hist))
        assert sim.dims == ("multivar", "period", "time")
        obj = mod.MBCn.train(ref, hist, base_kws={"nquantiles": 10, "group": "time"}, n_iter=2, n_escore=-1, rot_matrices=rots)
        out[mod] = obj, ref, hist, sim, obj.adjust(sim, ref, hist, period_dim="period")
    got, want = _np(out[xp][4]), _np(out[xt][4])
    assert out[xp][4].dims == out[xt][4].dims and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    obj, ref, hist, sim, _ = out[xp]
    one = xp.DataArray(sim.data[:, 1], ("multivar", "time"), {"time": ref.time, "multivar": np.array(["a", "b"])}, {"units": ""}, "d")
    np.testing.assert_allclose(got[:, 1], _np(obj.adjust(one, ref, hist)), rtol=1e-12, atol=1e-12)
