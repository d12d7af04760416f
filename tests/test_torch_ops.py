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
import xsdba_tpu_torch as xp


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


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
    """Cubic, once unported here, is ported (``tests/test_torch_cubic.py``
    holds it to the JAX package): a 5-node table gives its spline, which
    reproduces a cubic polynomial exactly; an unknown method still raises."""
    x = np.arange(5.0)
    got = tinterp.interp1d_table(torch.tensor([[0.5, 1.5, 3.25]]), x, x**3, "cubic").numpy()
    np.testing.assert_allclose(got, [[0.125, 3.375, 3.25**3]], rtol=1e-12)
    with pytest.raises(NotImplementedError, match="quadratic"):
        tinterp.interp1d_table(torch.zeros(2, 3, dtype=torch.float64), x, x, "quadratic")


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


# --------------------------------------------------------------------- fma


def _round_nearest_even(x, dtype):
    """The exact rational ``x`` rounded to nearest, ties to even, in
    ``dtype``'s format (subnormals and overflow included)."""
    from fractions import Fraction

    info = np.finfo(dtype)
    p, emin = info.nmant + 1, info.minexp
    if x == 0:
        return dtype(0.0)
    mag = abs(x)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    e -= mag < Fraction(2) ** e                    # 2^e <= mag < 2^(e + 1)
    ulp = Fraction(2) ** (max(e, emin) - p + 1)
    n, rest = divmod(mag, ulp)
    n += rest > ulp / 2 or (rest == ulp / 2 and n % 2 == 1)
    out = n * ulp
    if out > Fraction(float(info.max)):
        return dtype(np.copysign(np.inf, float(x)))
    # n * ulp has at most p significant bits: the conversions below are exact
    return dtype(np.copysign(np.ldexp(np.float64(int(n)), int(max(e, emin) - p + 1)), 1 if x > 0 else -1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fma_emulation_is_the_exactly_rounded_fused_result(dtype):
    """``fma`` on a CPU tensor (the emulation) on ``chip_smoke.py``'s operand recipe (scales
    2^-20 to 2^20, signed zeros, subnormals, products that cancel against
    ``c``) against exact rational arithmetic rounded once; a non-finite
    operand gives what the plain expression gives."""
    from fractions import Fraction

    from chip_smoke import fma_inputs
    from xsdba_tpu_torch.ops.cuda.fma_kernel import fma
    from xsdba_tpu_torch.utils.tensor import fma_emulated

    tdt = torch.float32 if dtype == np.float32 else torch.float64
    a, b, c = fma_inputs(600, tdt, seed=21)
    got = fma(a, b, c)
    assert got.dtype == tdt
    torch.testing.assert_close(fma_emulated(a, b, c), got, rtol=0, atol=0, equal_nan=True)  # a CPU tensor: the twin
    an, bn, cn, gn = (x.numpy() for x in (a, b, c, got))
    finite = np.isfinite(an) & np.isfinite(bn) & np.isfinite(cn)
    assert 400 < finite.sum() < 600 and (an[finite] == 0).any() and (np.abs(cn[finite]) < np.finfo(dtype).tiny).any()
    want = np.array([_round_nearest_even(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)), dtype)
                     for x, y, z in zip(an[finite], bn[finite], cn[finite])])
    np.testing.assert_array_equal(gn[finite], want)
    with np.errstate(invalid="ignore"):
        plain = an * bn + cn
    assert (gn[finite] != plain[finite]).sum() > 50                # the plain expression rounds twice
    np.testing.assert_array_equal(gn[~finite], plain[~finite])


@pytest.mark.parametrize("dtype", DTYPES)
def test_fma_emulation_gives_a_zero_the_fused_sign(dtype):
    """A zero result by bit pattern: a sum of signed zeros where a or b is
    zero, the rounded product's sign where it underflows against a zero c,
    +0 where the product cancels c (IEEE 754's fused multiply-add)."""
    from xsdba_tpu_torch.utils.tensor import fma_emulated

    tdt = torch.float32 if dtype == np.float32 else torch.float64
    tiny = 2.0**-80 if dtype == np.float32 else 2.0**-600          # tiny * tiny rounds to zero
    cases = [(-0.0, 1.0, -0.0, -0.0), (0.0, -1.0, -0.0, -0.0), (-0.0, -1.0, -0.0, 0.0), (0.0, 1.0, -0.0, 0.0),
             (-0.0, 1.0, 0.0, 0.0), (1.0, 1.0, -1.0, 0.0), (-3.0, 0.5, 1.5, 0.0), (-tiny, tiny, 0.0, -0.0),
             (-tiny, tiny, -0.0, -0.0), (tiny, tiny, -0.0, 0.0)]
    a, b, c, want = (torch.tensor(col, dtype=tdt) for col in zip(*cases))
    got = fma_emulated(a, b, c)
    assert torch.equal(got, want) and torch.equal(torch.signbit(got), torch.signbit(want))


def test_fma_broadcasts_and_checks_its_operands():
    """A CPU tensor takes the emulation and launches nothing; operands of
    mixed dtype or device are refused on the CPU as on the card, through the
    quantile lerp too."""
    from xsdba_tpu_torch.ops.cuda import fma_kernel
    from xsdba_tpu_torch.ops.cuda.fma_kernel import fma
    from xsdba_tpu_torch.ops.quantile import _lerp

    rng = np.random.default_rng(22)
    a, b, c = (torch.as_tensor(rng.normal(0, 1, s).astype(np.float32)) for s in ((4, 5, 6), (5, 6), (4, 1, 1)))
    before = fma_kernel.launches
    got = fma(a, b, c)
    assert got.shape == (4, 5, 6) and fma_kernel.launches == before
    full = [t.expand(4, 5, 6).contiguous() for t in (a, b, c)]
    torch.testing.assert_close(got, fma(*full), rtol=0, atol=0)
    with pytest.raises(TypeError):
        fma(a, b.double(), c)
    with pytest.raises(TypeError):
        fma(a.long(), b.long(), c.long())
    with pytest.raises(ValueError):
        fma(a, b.to("meta"), c)
    with pytest.raises(TypeError):
        _lerp(a, a + 1, torch.full((6,), 0.25, dtype=torch.float64))


# ------------------------------------------------ interp_on_quantiles_grouped


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("group", ["time.month", "time", "time.dayofyear", "time.season"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_interp_on_quantiles_grouped(dtype, group, method):
    """The grouped lookup with cyclic blending against the reference's
    compiled one, under ==: G = 12, 1, 365 and 4 groups, a NaN table row, a
    NaN value; brackets computed on the host in the data's dtype."""
    import jax

    import xsdba_tpu as xt
    from xsdba_tpu.ops.interp import interp_on_quantiles_grouped as jgrouped
    from xsdba_tpu_torch.ops.interp import interp_on_quantiles_grouped

    rng = np.random.default_rng(0)
    gi = xt.Grouper(group).indexes(xt.date_range("2001-01-01", periods=730, freq="D", calendar="noleap"))
    G = len(gi.positions)
    xq = np.sort(rng.normal(0, 1, (3, G, 9)), -1).astype(dtype)
    yq = rng.normal(0, 1, (3, G, 9)).astype(dtype)
    if G > 2:
        xq[1, 2] = np.nan
        yq[2, 1, 4] = np.nan
    v = rng.normal(0, 1.5, (3, 730)).astype(dtype)
    v[0, 5] = np.nan
    want = np.asarray(jax.jit(lambda a, b, c: jgrouped(a, gi.frac_idx, b, c, gi.positions, method, "constant"))(v, xq, yq))
    got = interp_on_quantiles_grouped(torch.as_tensor(v), gi.frac_idx, torch.as_tensor(xq), torch.as_tensor(yq), gi.positions, method, "constant")
    assert got.dtype == torch.as_tensor(v).dtype and tuple(got.shape) == v.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_interp_on_quantiles_grouped_routes_through_the_3d_lookup(monkeypatch):
    """float32 tables of at most 64 nodes go through K1's wrapper on partition
    rows, nearest (one partition) and linear (two)."""
    import xsdba_tpu_torch as xp
    from xsdba_tpu_torch.ops import interp as tinterp

    seen = []
    real = tinterp.interp_table_3d
    monkeypatch.setattr(tinterp, "interp_table_3d", lambda v, xs, ys, nv, method: seen.append((tuple(v.shape[:2]), method)) or real(v, xs, ys, nv, method))
    gi = xp.Grouper("time.season").indexes(xp.date_range("2001-01-01", periods=400, freq="D", calendar="noleap"))
    rng = np.random.default_rng(1)
    xq = torch.as_tensor(np.sort(rng.normal(0, 1, (2, 4, 7)), -1), dtype=torch.float32)
    yq = torch.as_tensor(rng.normal(0, 1, (2, 4, 7)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(0, 1, (2, 400)), dtype=torch.float32)
    tinterp.interp_on_quantiles_grouped(v, gi.frac_idx, xq, yq, gi.positions, "nearest")
    assert seen == [((2, 6), "nearest")]
    tinterp.interp_on_quantiles_grouped(v, gi.frac_idx, xq, yq, gi.positions, "linear")
    assert seen[1:] == [((2, 6), "linear")] * 2
    tinterp.interp_on_quantiles_grouped(v.double(), gi.frac_idx, xq.double(), yq.double(), gi.positions, "nearest")
    assert len(seen) == 3
