"""The port's tensor operators against the JAX package's, on the CPU.

Each case draws its inputs from a numpy seed and hands the same arrays to
the ``xsdba_tpu`` function and its ``xsdba_tpu_torch`` counterpart.
Tolerances: float64 within 1e-12; float32 within rtol = atol = 2e-6, the
room XLA's CPU FMA contraction takes (as in ``tests/test_pallas.py``).
"""

import os

import numpy as np
import pytest
import torch

import xsdba_tpu.ops.correction as jcorr
import xsdba_tpu.ops.interp as jinterp
import xsdba_tpu.ops.quantile as jquant
import xsdba_tpu.ops.rank as jrank
import xsdba_tpu.ops.segment as jseg
import xsdba_tpu_torch.ops.correction as tcorr
import xsdba_tpu_torch.ops.interp as tinterp
import xsdba_tpu_torch.ops.quantile as tquant
import xsdba_tpu_torch.ops.rank as trank
import xsdba_tpu_torch.ops.segment as tseg
from xsdba_tpu.utils.calendar import date_range
from xsdba_tpu.utils.grouper import Grouper

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12), np.float32: dict(rtol=2e-6, atol=2e-6)}
DTYPES = [np.float64, np.float32]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, dtype):
    got = _np(got)
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got, _np(want), equal_nan=True, **TOL[dtype])


def _series(rng, shape, dtype, nan_frac=0.05):
    x = rng.normal(10, 3, shape)
    x[rng.random(shape) < nan_frac] = np.nan
    return x.astype(dtype)


def _month_indexes(years=3):
    return Grouper("time.month").indexes(date_range("2001-01-01", periods=365 * years, freq="D", calendar="noleap"))


# ---------------------------------------------------------------- quantiles


@pytest.mark.parametrize("dtype", DTYPES)
def test_nan_quantile(dtype):
    rng = np.random.default_rng(1)
    x = _series(rng, (4, 5, 37), dtype, nan_frac=0.2)
    x[0, 0] = np.nan          # all-NaN row
    x[1, 1, 1:] = np.nan      # single valid value
    q = np.array([0.0, 0.01, 0.25, 0.5, 0.77, 0.99, 1.0], dtype)
    for axis in (-1, 1):
        _close(tquant.nan_quantile(torch.as_tensor(x), q, axis=axis), jquant.nan_quantile(x, q, axis=axis), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vecquantiles(dtype):
    rng = np.random.default_rng(2)
    x = _series(rng, (6, 40), dtype)
    ranks = rng.random(6).astype(dtype)
    ranks[2] = np.nan
    _close(tquant.vecquantiles(torch.as_tensor(x), torch.as_tensor(ranks)), jquant.vecquantiles(x, ranks), dtype)


@pytest.mark.parametrize("group_chunk", [None, 5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_nan_quantile(dtype, group_chunk):
    rng = np.random.default_rng(3)
    gi = _month_indexes()
    x = _series(rng, (3, len(gi.group_idx)), dtype)
    q = tcorr.equally_spaced_nodes(15).astype(dtype)
    want = jquant.grouped_nan_quantile(x, gi.gather_idx, q, group_chunk=group_chunk)
    got = tquant.grouped_nan_quantile(torch.as_tensor(x), gi.gather_idx, q, group_chunk=group_chunk)
    assert got.shape == (3, 12, 15)
    _close(got, want, dtype)


# -------------------------------------------------------------------- ranks


def _rank_rows(dtype):
    """Rows mixing ties, +inf, -inf and NaN (ROADMAP trap C1: NaN ranks
    after genuine +inf and never joins its tie run)."""
    rng = np.random.default_rng(4)
    x = np.round(rng.normal(0, 2, (5, 24)), 0).astype(dtype)  # many ties
    x[0, [3, 7]] = np.inf
    x[0, [5, 11]] = np.nan
    x[1, 0] = np.inf                # a lone +inf next to the NaN block
    x[1, 1:4] = np.nan
    x[2, :] = np.nan                # all NaN
    x[3, [2, 9]] = -np.inf
    x[4, :] = 1.5                   # one tie run
    return x


@pytest.mark.parametrize("dtype", DTYPES)
def test_ranks_with_inf_nan_and_ties(dtype):
    x = _rank_rows(dtype)
    xt = torch.as_tensor(x)
    _close(trank.average_rank(xt), jrank.average_rank(x), dtype)
    _close(trank.pct_rank(xt), jrank.pct_rank(x), dtype)
    _close(trank.rank_pct_rescaled(xt), jrank.rank_pct_rescaled(x), dtype)
    _close(trank.average_rank(xt.T, axis=0), jrank.average_rank(x.T, axis=0), dtype)
    got = trank.rank_pct_rescaled_with_sorted(xt)
    want = jrank.rank_pct_rescaled_with_sorted(x)
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_rank(dtype):
    rng = np.random.default_rng(5)
    gi = _month_indexes()
    x = np.round(_series(rng, (2, len(gi.group_idx)), np.float64), 1).astype(dtype)
    x[0, 50] = np.inf
    x[1, 51] = np.inf
    args = (gi.gather_idx, gi.group_idx, gi.scatter_slot)
    for pct in (False, True):
        _close(tseg.grouped_rank(torch.as_tensor(x), *args, pct=pct), jseg.grouped_rank(x, *args, pct=pct), dtype)
    q = tcorr.equally_spaced_nodes(9).astype(dtype)
    got = tseg.grouped_rank_and_quantile(torch.as_tensor(x), *args, q)
    want = jseg.grouped_rank_and_quantile(x, *args, q)
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_mean_std_and_scatter(dtype):
    rng = np.random.default_rng(6)
    gi = _month_indexes(2)
    x = _series(rng, (3, len(gi.group_idx)), dtype)
    xt = torch.as_tensor(x)
    _close(tseg.grouped_mean(xt, gi.gather_idx), jseg.grouped_mean(x, gi.gather_idx), dtype)
    _close(tseg.grouped_std(xt, gi.gather_idx, ddof=1), jseg.grouped_std(x, gi.gather_idx, ddof=1), dtype)
    g = tseg.gather_groups(xt, gi.gather_idx)
    _close(tseg.scatter_back(g, gi.group_idx, gi.scatter_slot), x, dtype)


# --------------------------------------------------------------- correction


@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_correction(kind, dtype):
    rng = np.random.default_rng(7)
    a = rng.uniform(1, 3, (4, 12)).astype(dtype)
    b = rng.uniform(1, 3, (4, 12)).astype(dtype)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    _close(tcorr.get_correction(at, bt, kind), jcorr.get_correction(a, b, kind), dtype)
    _close(tcorr.apply_correction(at, bt, kind), jcorr.apply_correction(a, b, kind), dtype)
    _close(tcorr.invert(at, kind), jcorr.invert(a, kind), dtype)
    gi = _month_indexes(2)
    for interp in ("nearest", "linear"):
        args = (gi.frac_idx, gi.group_idx, gi.positions, interp)
        _close(tcorr.broadcast_group_factors(at, *args), jcorr.broadcast_group_factors(a, *args), dtype)
    x = _series(rng, (4, 30), dtype)
    val = rng.normal(10, 3, 4).astype(dtype)
    _close(tcorr.ecdf(torch.as_tensor(x), torch.as_tensor(val)), jcorr.ecdf(x, val), dtype)


# ------------------------------------------------------------ table lookup


def _tables(rng, shape, nq, dtype):
    xq = np.sort(rng.normal(0, 2, shape + (nq,)), axis=-1)
    yq = rng.normal(0, 1, shape + (nq,))
    xq.reshape(-1, nq)[0, 3] = np.nan     # NaN pairs inside tables
    yq.reshape(-1, nq)[1, 5] = np.nan
    xq.reshape(-1, nq)[2, :] = np.nan     # an empty table
    yq.reshape(-1, nq)[3, 1:] = np.nan    # a single valid node
    return xq.astype(dtype), yq.astype(dtype)


@pytest.mark.parametrize("nq", [12, 70])
@pytest.mark.parametrize("extrap", ["constant", "nan"])
@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_interp1d_table(dtype, method, extrap, nq):
    """Both the unrolled form (nq <= 64) and the binary-search form."""
    rng = np.random.default_rng(8)
    xq, yq = _tables(rng, (6,), nq, dtype)
    v = (rng.normal(0, 3, (6, 50))).astype(dtype)
    v[0, 0] = np.nan
    v[3, 1] = xq[3, 0]                    # exactly on the single node
    got = tinterp.interp1d_table(torch.as_tensor(v), xq, yq, method, extrap)
    want = jinterp.interp1d_table(v, xq, yq, method, extrap)
    _close(got, want, dtype)


def test_cubic_not_ported():
    with pytest.raises(NotImplementedError, match="A7"):
        tinterp.interp1d_table(torch.zeros(2, 3), np.arange(5.0), np.arange(5.0), "cubic")


@pytest.mark.parametrize("tables_compact", [False, True])
@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_interp_grouped_partitioned(dtype, method, tables_compact):
    rng = np.random.default_rng(9)
    gi = _month_indexes()
    T = len(gi.group_idx)
    xq = np.sort(rng.normal(10, 3, (3, 12, 20)), axis=-1).astype(dtype)
    yq = rng.normal(0, 1, (3, 12, 20)).astype(dtype)
    xq[1, 4] = yq[1, 4] = np.nan          # an unfitted group (whole NaN row)
    v = _series(rng, (3, T), dtype)
    b = gi.bracket_partitions(method)
    parts = [b[k] for k in ("part0", "g0", "slot0", "part1", "g1", "slot1", "w")]
    if method == "nearest":
        parts[3:] = [None] * 4
    want = jinterp.interp_grouped_partitioned(v, xq, yq, *parts, method, "constant", tables_compact=tables_compact)
    got = tinterp.interp_grouped_partitioned(
        torch.as_tensor(v), torch.as_tensor(xq), torch.as_tensor(yq), *parts, method, "constant",
        tables_compact=tables_compact,
    )
    _close(got, want, dtype)


@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_interp_on_quantiles_reference(method):
    """The host scipy lookup behind ``mode="reference"``."""
    rng = np.random.default_rng(10)
    gi = _month_indexes(1)
    xq = np.sort(rng.normal(10, 3, (2, 12, 8)), axis=-1)
    yq = rng.normal(0, 1, (2, 12, 8))
    v = rng.normal(10, 4, (2, len(gi.group_idx)))
    newg = gi.frac_idx if method != "nearest" else gi.positions[gi.group_idx]
    args = (newg, xq, yq, gi.positions)
    np.testing.assert_array_equal(
        tinterp.interp_on_quantiles_reference(v, *args, method=method),
        jinterp.interp_on_quantiles_reference(v, *args, method=method),
    )


# ------------------------------------------------------------------ golden


@pytest.fixture(scope="module")
def pack():
    return np.load(GOLDEN)


def test_golden_type7_nan_quantile(pack):
    got = tquant.nan_quantile(torch.as_tensor(pack["q7_x"]), pack["q7_q"], axis=-1)
    np.testing.assert_allclose(_np(got), pack["q7_want"], rtol=1e-12, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("extrap", ["constant", "nan"])
def test_golden_interp1d_nan_edges(pack, method, extrap):
    got = tinterp.interp1d_table(torch.as_tensor(pack["i1_newx"]), pack["i1_xq"], pack["i1_yq"], method=method, extrap=extrap)
    np.testing.assert_allclose(_np(got), pack[f"i1_want_{method}_{extrap}"], rtol=1e-12, atol=1e-12, equal_nan=True)


def test_golden_grouped_interp_matches_griddata_isolines(pack):
    """The g2 tables through the port's grouped lookup, bracketed by the
    month grouping of the calendar year the golden ``g2_frac`` comes from
    (``tests/test_golden.py`` pins that index)."""
    gi = Grouper("time.month").indexes(date_range("2001-01-01", periods=365, freq="D", calendar="standard"))
    np.testing.assert_allclose(gi.frac_idx, pack["g2_frac"], rtol=0, atol=1e-14)
    np.testing.assert_array_equal(gi.positions, pack["g2_pos"])
    b = gi.bracket_partitions("linear")
    got = tinterp.interp_grouped_partitioned(
        torch.as_tensor(pack["g2_newx"]), pack["g2_xq"], pack["g2_yq"],
        *(b[k] for k in ("part0", "g0", "slot0", "part1", "g1", "slot1", "w")), "linear", "constant",
    )
    np.testing.assert_allclose(_np(got), pack["g2_want"], rtol=1e-10, atol=1e-12)
