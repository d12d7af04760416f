"""The roofline arithmetic on fixed shapes, worked out by hand."""

import math

import pytest

from portbench import roofline, run
from portbench.reference import calendar


def _shapes(cell):
    c = run.Cell(cell)
    return roofline.shapes(c.config, c.mix, c.days)


def test_peaks():
    assert roofline.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert roofline.bound_s(1.0, 67e12 * 2) == (2.0, "comparisons")


def test_qdm_full150():
    s = _shapes("qdm_month_tas.full150")
    assert (s["sites"], s["train_days"], s["sim_days"], s["nquantiles"]) == (4096, 54750, 54750, 50)
    assert list(s["group_sizes"]) == [150 * d for d in (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)]
    n_bytes, n_ops = roofline.quantile_work(s)
    assert n_bytes == 8192 * (54750 + 12 * 50) * 4
    per_row = sum(150 * d * math.log2(150 * d) for d in (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31))
    assert per_row < 54750 * math.log2(54750)  # disjoint groups: their own sorts are less work
    assert n_ops == pytest.approx(8192 * per_row, rel=1e-12)
    t, which = roofline.bound_s(n_bytes, n_ops)
    assert which == "bytes" and t == pytest.approx(1_813_708_800 / 3.35e12)
    n_bytes, n_ops = roofline.lookup_work(s)
    assert n_bytes == (4096 * (2 * 54750 + 12 * 50) + 50) * 4       # ranks in, factors out, af tables, shared nodes
    assert n_ops == pytest.approx(4096 * 54750 * math.log2(50) * 2)  # two bracketing months


def test_eqm_cal30():
    s = _shapes("eqm_doy31_tas.cal30_sim150")
    assert (s["sites"], s["train_days"], s["sim_days"], s["window"]) == (8192, 10950, 54750, 31)
    assert len(s["group_sizes"]) == 365 and s["group_sizes"].max() == 930 and s["group_sizes"].min() == 930 - 15
    n_bytes, n_ops = roofline.quantile_work(s)
    assert n_bytes == 16384 * (10950 + 365 * 50) * 4
    # overlapping windows: one order of the series bounds every group's
    assert n_ops == pytest.approx(16384 * 10950 * math.log2(10950), rel=1e-12)
    n_bytes, n_ops = roofline.lookup_work(s)
    assert n_bytes == 8192 * (2 * 54750 + 365 * 50 * 2) * 4           # hist_q and af tables
    assert n_ops == pytest.approx(8192 * 54750 * math.log2(50))        # one day-of-year table


def test_groupings_without_a_formula_read_nothing():
    c = run.Cell("eqm_doy31_tas.full150")
    season = dict(c.config, train=dict(c.config["train"], group="time.season", window=1))
    assert roofline.shapes(season, c.mix, c.days) is None
    ctx = run.Context(season, c.mix, c.days)
    ctx.layers, ctx.layer_blocks = {"lookup": 1e-3, "quantile": 1e-3, "total": 2e-3}, 1
    for name in ("lookup_roofline", "quantile_roofline"):
        assert run.spec.reader(name).read(ctx) is None
    ctx = run.Context(c.config, c.mix, c.days)
    ctx.layers, ctx.layer_blocks = {"lookup": 1e-3, "quantile": 1e-3, "total": 2e-3}, 1
    assert 0 < run.spec.reader("lookup_roofline").read(ctx) < 100


def test_whole_series_and_standard_calendar():
    c = run.Cell("eqm_doy31_tas.cal30_sim150")
    whole = dict(c.config, train=dict(c.config["train"], group="time", window=1))
    s = roofline.shapes(whole, c.mix, c.days)
    assert list(s["group_sizes"]) == [10950] and not s["blended"]
    doy = dict(c.config, train=dict(c.config["train"], group="time.dayofyear", window=31))
    days = {p: calendar.days("standard", c.mix[f"{p}_start"], c.mix[f"{p}_years"]) for p in ("train", "sim")}
    s = roofline.shapes(doy, c.mix, days)
    assert len(s["group_sizes"]) == 366 and s["group_sizes"][365] == 7 * 31 and s["sim_days"] == 54787
