"""The plain reference against the port's CPU path, at tiny sizes of both
mixes and of the variants a later cell may take (a standard calendar,
kind ``"*"``, NaN-masked sites and days), and the bfloat16 control
against the limits."""

import numpy as np
import pytest
import torch

import xsdba_tpu_torch as xt
from portbench import check, gen, spec
from portbench.reference import calendar, qm
from portbench.run import Cell

from .cells import CELLS

#: variants of a cell: its configuration's train keys, its mix's keys
VARIANTS = {
    "as_is": ({}, {}),
    "standard_calendar": ({}, {"calendar": "standard"}),
    "multiplicative": ({"kind": "*"}, {}),
    "nan_masked": ({}, {"nan_sites": 0.2, "nan_values": 0.05}),
}


def _port(config, inputs, days, mix, cal):
    times = {p: xt.date_range(mix[f"{p}_start"], periods=d.n, freq="D", calendar=cal) for p, d in days.items()}
    da = {k: xt.DataArray(torch.from_numpy(x), ("site", "time"), {"time": times[config["inputs"][k]]}, {"units": "K"}, "tas")
          for k, x in inputs.items()}
    obj = getattr(xt, config["class"]).train(*(da[k] for k in config["train_inputs"]), **config["train"])
    scen = obj.adjust(*(da[k] for k in config["adjust_inputs"]), **config["adjust"])
    return {"scen": scen.data.numpy(), "af": obj.ds["af"].data.numpy(), "hist_q": obj.ds["hist_q"].data.numpy()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_equals_port_cpu(cell, seed, variant, merge_engine, tiny_root):
    c = Cell(cell, tiny_root)
    train_kw, mix_kw = VARIANTS[variant]
    config = dict(c.config, train=dict(c.config["train"], **train_kw))
    mix = dict(c.mix, **mix_kw)
    cal = mix.get("calendar", config["calendar"])
    days = {p: calendar.days(cal, mix[f"{p}_start"], mix[f"{p}_years"]) for p in ("train", "sim")}
    rng = np.random.default_rng(seed)

    def series(d, off, warm=0.0):
        cyc = 12 * np.cos(2 * np.pi * (d.doy - 200) / 365)
        return (280 + off + cyc + rng.normal(0, 3, (5, d.n)) + warm * (d.year - d.year.mean()) / 100).astype(np.float32)

    inputs = {"ref": series(days["train"], 0), "hist": series(days["train"], 2), "sim": series(days["sim"], 2, 40)}
    g = torch.Generator().manual_seed(seed)
    inputs = {k: v.numpy() for k, v in gen.mask(g, {k: torch.from_numpy(v) for k, v in inputs.items()}, mix).items()}
    got = _port(config, inputs, days, mix, cal)
    want = qm.train_adjust(config, inputs, days)
    limit, gap = c.limits["scen_max_abs_K"]["limit"], spec.module("measures", "max_abs").gap
    for out in ("scen", "af", "hist_q"):
        assert got[out].shape == want[out].shape, out
        assert gap(got[out], want[out]) <= limit, (out, gap(got[out], want[out]))
    if variant == "nan_masked":
        assert np.isnan(want["scen"]).any() and np.isfinite(want["scen"]).any()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_bfloat16_control_is_not_correct(cell, seed, tiny_root):
    """The reference in bfloat16, put in the program's place, fails the
    cell's limits (the control of the comparison)."""
    c = Cell(cell, tiny_root)
    c.setup(seed, "cpu")
    _, inputs = c.samples_to_host()
    want = c.expected(inputs)
    low = c.expected(inputs, rnd=qm.bfloat16)
    verdict = check.compare(sorted(low.items()), want, c.limits, root=tiny_root)
    assert not verdict["correct"] and verdict["failed"] == len(low)


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 280.7, -3.3e-3])
    got = qm.bfloat16(x)
    want = torch.from_numpy(x).to(torch.bfloat16).to(torch.float64).numpy()
    assert np.array_equal(got, want)


def test_calendar_groups():
    days = calendar.days("noleap", "1981-01-01", 3)
    assert days.n == 1095 and days.doy[364] == 365 and days.doy[365] == 1
    assert [len(m) for m in calendar.month_members(days)] == [93, 84, 93, 90, 93, 90, 93, 93, 90, 93, 90, 93]
    rows = calendar.window_members(days, 31)
    assert rows.shape == (365, 93)
    # day of year 1: the first year's lacks the 15 days before it
    assert (rows[0] >= 0).sum() == 93 - 15 and (rows[364] >= 0).sum() == 93 - 15
    assert (rows[180] >= 0).sum() == 93
    with pytest.raises(ValueError):
        calendar.days("noleap", "1981-02-01", 1)


def test_standard_calendar():
    days = calendar.days("standard", "1999-01-01", 3)                 # 2000 is a leap year
    assert days.n == 365 * 3 + 1 and days.doy.max() == 366
    feb29 = 365 + 31 + 28
    assert (days.year[feb29], days.month[feb29], days.day[feb29], days.month_len[feb29]) == (2000, 2, 29, 29)
    assert days.doy[365 + 365] == 366 and days.doy[365 + 366] == 1
    assert not calendar.is_leap(np.array([1900, 2100])).any() and calendar.is_leap(np.array([2000, 2004])).all()
    want = np.array([np.datetime64("1999-01-01") + np.timedelta64(i, "D") for i in range(days.n)])
    assert np.array_equal(want.astype("datetime64[Y]").astype(int) + 1970, days.year)
    rows = calendar.window_members(days, 31)
    assert rows.shape == (366, 3 * 31) and (rows[365] >= 0).sum() == 31  # day 366: one centre


def test_month_brackets():
    days = calendar.days("noleap", "2000-01-01", 1)
    g0, g1, w = qm.month_brackets(days)
    # January 1: between December's centre and January's
    assert (g0[0], g1[0]) == (11, 0) and w[0] == pytest.approx(0.5 + 1 / 31)
    # February 14: at February's centre exactly
    i = 31 + 13
    assert (g0[i], g1[i], w[i]) == (1, 2, 0.0)
    # December 31: between December and the next January
    assert (g0[-1], g1[-1]) == (11, 0) and w[-1] == pytest.approx(0.5)


def test_every_cell_has_numbers_and_a_reference():
    bench = spec.load_benchmark()
    for cell in bench["workloads"]:
        numbers = spec.limits(cell)
        assert numbers and all(n["limit"] > 0 and callable(spec.module("measures", n["measure"]).gap) for n in numbers.values())
        config = spec.config(bench, cell)
        assert hasattr(spec.reference(config), "train_adjust")
        assert hasattr(spec.module("generators", config["generator"]), "make_block")


def test_sampled_sites_cover_every_chunk():
    """First and last site, one a stratum: any run of sites a chunk of the
    windowed path covers (632 rows of ref and hist at 150 years) holds one."""
    sites = check.sample_sites(2**31 + 3, 3, 4096, 32)
    assert sites.shape == (3, 34) and (sites[:, 0] == 0).all() and (sites[:, -1] == 4095).all()
    assert (np.diff(sites, axis=1) < 2 * 4096 // 32).all() and (np.diff(sites, axis=1) >= 0).all()
    assert not np.array_equal(sites, check.sample_sites(2**31 + 4, 3, 4096, 32))


def test_max_abs_measure():
    gap = spec.module("measures", "max_abs").gap
    nan, inf = np.nan, np.inf
    assert gap(np.array([1.0, nan, inf]), np.array([1.5, nan, inf])) == 0.5
    assert gap(np.array([1.0, nan]), np.array([1.0, 2.0])) == inf
    assert gap(np.array([1.0, 2.0]), np.array([1.0, nan])) == inf
    assert gap(np.array([inf]), np.array([-inf])) == inf
    assert gap(np.zeros(2), np.zeros(3)) == inf
