"""The port's time-grouping lowering against the JAX package's.

``xsdba_tpu_torch.utils.grouper`` is a copy of the reference's host-side
index lowering; every index array it hands the tensor cores must equal the
reference's exactly, for each grouping the quantile-mapping path supports
(and the windowed ones whose merge plans the next slices will consume).
"""

import dataclasses

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu.utils.grouper import Grouper as RefGrouper
from xsdba_tpu_torch.utils.grouper import Grouper

CASES = [
    ("time.month", 1, "noleap"),
    ("time.month", 1, "standard"),
    ("time.season", 1, "standard"),
    ("time.dayofyear", 31, "noleap"),
    ("time.dayofyear", 31, "standard"),
    ("time.dayofyear", 1, "360_day"),
    ("5D", 3, "noleap"),
    ("time", 1, "noleap"),
]


def _indexes(group, window, calendar, periods=365 * 3 + 40):
    args = ("1990-01-01",)
    kw = dict(periods=periods, freq="D", calendar=calendar)
    want = RefGrouper(group, window=window).indexes(xt.date_range(*args, **kw))
    got = Grouper(group, window=window).indexes(xp.date_range(*args, **kw))
    return want, got


def _assert_same(want, got, where):
    if want is None or got is None:
        assert want is None and got is None, where
        return
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=where)
        assert np.asarray(got).dtype == want.dtype, where
    else:
        assert got == want, where


@pytest.mark.parametrize("group,window,calendar", CASES)
def test_group_indexes_equal_reference(group, window, calendar):
    want, got = _indexes(group, window, calendar)
    for f in dataclasses.fields(want):
        if f.name == "merge_plan":
            continue
        _assert_same(getattr(want, f.name), getattr(got, f.name), f.name)
    np.testing.assert_array_equal(got.positions, want.positions)
    assert (want.merge_plan is None) == (got.merge_plan is None)
    if want.merge_plan is not None:
        for f in dataclasses.fields(want.merge_plan):
            _assert_same(getattr(want.merge_plan, f.name), getattr(got.merge_plan, f.name), f"merge_plan.{f.name}")


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("group,window,calendar", CASES)
def test_bracket_partitions_equal_reference(group, window, calendar, method):
    want, got = _indexes(group, window, calendar)
    bw, bg = want.bracket_partitions(method), got.bracket_partitions(method)
    assert bw.keys() == bg.keys()
    for k in bw:
        _assert_same(bw[k], bg[k], k)


@pytest.mark.parametrize("group,window,calendar", [CASES[0], CASES[3], CASES[6]])
def test_expand_equal_reference(group, window, calendar):
    """Pooled ``add_dims`` training indexes (``GroupIndexes.expand``)."""
    want, got = _indexes(group, window, calendar, periods=365 * 2)
    we, ge = want.expand(3), got.expand(3)
    for name in ("gather_idx", "group_idx", "scatter_slot", "group_counts", "frac_idx"):
        _assert_same(getattr(we, name), getattr(ge, name), name)
    if we.merge_plan is not None:
        for name in ("w1_gather", "edge_gather", "nv_host", "sel_labels"):
            _assert_same(getattr(we.merge_plan, name), getattr(ge.merge_plan, name), name)


@pytest.mark.parametrize(
    "group,window,func",
    [
        ("time.season", 1, "mean"),
        ("time.month", 1, "std"),
        ("time.dayofyear", 5, "max"),
        ("time.month", 1, "demean"),
    ],
)
def test_grouper_apply_matches_reference(group, window, func):
    """``Grouper.apply``: named reductions and a group-wise transform that
    scatters back to time, on float64 data with NaN holes."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    T = 365 * 2
    x = rng.normal(5, 2, (3, T))
    x[0, 10:40] = np.nan
    dims, attrs = ("site", "time"), {"units": "K"}
    ref_da = xt.DataArray(x, dims, {"time": xt.date_range("2000-01-01", periods=T, freq="D", calendar="noleap")}, attrs, "tas")
    da = xp.DataArray(torch.as_tensor(x), dims, {"time": xp.date_range("2000-01-01", periods=T, freq="D", calendar="noleap")}, attrs, "tas")
    if func == "demean":
        want = RefGrouper(group, window=window).apply(lambda v: v - jnp.nanmean(v, axis=-1, keepdims=True), ref_da)
        got = Grouper(group, window=window).apply(lambda v: v - torch.nanmean(v, dim=-1, keepdim=True), da)
    else:
        want = RefGrouper(group, window=window).apply(func, ref_da)
        got = Grouper(group, window=window).apply(func, da)
    assert got.dims == want.dims
    assert isinstance(got.data, torch.Tensor)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-12, atol=1e-12, equal_nan=True)
