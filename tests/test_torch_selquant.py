"""The port's counting-selection engine (``ops/selquant.py``) against the JAX
package, on the CPU.

Every comparison is bit for bit (``assert_array_equal``, NaN equal to NaN):
the engine selects the same floats as the reference's selection engine and
its jitted re-sort oracle, and rounds the type-7 virtual index and the lerp
as the reference's compiled programs do (fused multiply-adds).  Covered:
float32 and float64, windows 5 and 31, finite data, NaN gaps, an all-NaN
row, alpha/beta other than 1, every stage-1 sort (``lax``, ``xla``, and
``pallas``, whose wrapper runs the kernel's twin on a CPU tensor), ascending
and shuffled quantiles, chunked batches, and the public windowed EQM with
default options in both packages (the CPU's default engine is selection in
both).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu.models import _algos as jalgos
from xsdba_tpu.models._wrap import device_brackets as jbrackets
from xsdba_tpu.ops.quantile import grouped_nan_quantile as jgnq
from xsdba_tpu.ops.quantile import windowed_group_quantile as jwgq
from xsdba_tpu_torch.models import _algos as palgos
from xsdba_tpu_torch.models._wrap import device_brackets
from xsdba_tpu_torch.ops import quantile as pq
from xsdba_tpu_torch.ops import selquant as ps
from xsdba_tpu_torch.ops.correction import equally_spaced_nodes


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@functools.lru_cache(maxsize=None)
def _indexes(window, years=6, calendar="noleap"):
    kw = dict(periods=365 * years, freq="D", calendar=calendar)
    gj = xt.Grouper("time.dayofyear", window=window).indexes(xt.date_range("1980-01-01", **kw))
    gp = xp.Grouper("time.dayofyear", window=window).indexes(xp.date_range("1980-01-01", **kw))
    return gj, gp


def _data(dtype, T, seed=7):
    """Four sites: finite, 10 % NaN, all NaN, and finite with ties."""
    rng = np.random.default_rng(seed)
    x = rng.normal(10, 3, (4, T))
    x[1, rng.random(T) < 0.1] = np.nan
    x[2] = np.nan
    x[3] = np.round(x[3])
    return x.astype(dtype)


@functools.lru_cache(maxsize=None)
def _reference(dtype, window):
    """The reference's engine (default options) and its jitted oracle."""
    gj, _ = _indexes(window)
    x = _data(dtype, gj.gather_idx.max() + 1)
    q = equally_spaced_nodes(20).astype(dtype)
    engine = np.asarray(jwgq(x, gj.merge_plan, q))
    oracle = np.asarray(jax.jit(lambda a, b: jgnq(a, gj.gather_idx, b))(jnp.asarray(x), jnp.asarray(q)))
    return x, q, engine, oracle


# the row sort's kernel takes float32 only: float64 sorts through lax or xla
SORTS = [(np.float32, "lax"), (np.float32, "xla"), (np.float32, "pallas"), (np.float64, "lax"), (np.float64, "xla")]


@pytest.mark.parametrize("window", [5, 31])
@pytest.mark.parametrize("dtype,sort_impl", SORTS)
def test_engine_matches_reference_bitwise(dtype, window, sort_impl):
    _, gp = _indexes(window)
    x, q, engine, oracle = _reference(dtype, window)
    _equal(engine, oracle)
    got = ps.selection_windowed_quantile(torch.from_numpy(x), gp.merge_plan, q, sort_impl=sort_impl)
    assert got.dtype == torch.from_numpy(x).dtype and tuple(got.shape) == (4, 365, 20)
    _equal(got, engine)
    assert bool(torch.isnan(got[2]).all()) and not bool(torch.isnan(got[[0, 1, 3]]).any())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_default_windowed_quantile_selects_and_matches_reference(dtype):
    """``windowed_group_quantile`` takes the selection engine on the CPU by
    default, as the reference does."""
    _, gp = _indexes(31)
    x, q, engine, _ = _reference(dtype, 31)
    assert ps.selection_ok(gp.merge_plan, q, "cpu")
    _equal(pq.windowed_group_quantile(torch.from_numpy(x), gp.merge_plan, q), engine)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("alpha,beta", [(0.4, 0.4), (0.0, 1.0), (1.0 / 3, 1.0 / 3)])
def test_alpha_beta(dtype, alpha, beta):
    gj, gp = _indexes(15, years=4)
    x = _data(dtype, 365 * 4, seed=3)
    q = equally_spaced_nodes(12).astype(dtype)
    want = np.asarray(jwgq(x, gj.merge_plan, q, alpha=alpha, beta=beta))
    oracle = jax.jit(lambda a, b: jgnq(a, gj.gather_idx, b, alpha=alpha, beta=beta))(jnp.asarray(x), jnp.asarray(q))
    got = ps.selection_windowed_quantile(torch.from_numpy(x), gp.merge_plan, q, alpha=alpha, beta=beta)
    _equal(got, want)
    _equal(got, oracle)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_shuffled_quantiles(dtype):
    """q in any order: each column is computed on its own, then
    un-permuted."""
    gj, gp = _indexes(31)
    x = _data(dtype, 365 * 6, seed=5)
    q = np.random.default_rng(0).permutation(equally_spaced_nodes(17)).astype(dtype)
    got = ps.selection_windowed_quantile(torch.from_numpy(x), gp.merge_plan, q)
    _equal(got, jwgq(x, gj.merge_plan, q))
    _equal(got[..., np.argsort(q)], ps.selection_windowed_quantile(torch.from_numpy(x), gp.merge_plan, np.sort(q)))


def test_chunked_batch_agrees(monkeypatch):
    _, gp = _indexes(5)
    x, q, engine, _ = _reference(np.float32, 5)
    monkeypatch.setattr(ps, "max_chunk", lambda *a, **k: 3)
    got = ps.selection_windowed_quantile(torch.from_numpy(x).reshape(4, 1, -1), gp.merge_plan, q)
    assert tuple(got.shape) == (4, 1, 365, 20)
    _equal(got[:, 0], engine)


@pytest.mark.parametrize("Wb,nb_chunk,g_chunk", [(32, 4, 100), (128, 1, 365)])
def test_block_sizes_change_no_result(Wb, nb_chunk, g_chunk):
    """The reference's block and chunk sizes reach the core and leave every
    selected value as it is (pure performance knobs in both packages)."""
    _, gp = _indexes(5)
    x, q, engine, _ = _reference(np.float32, 5)
    got = ps.selection_windowed_quantile(torch.from_numpy(x), gp.merge_plan, q, Wb=Wb, nb_chunk=nb_chunk, g_chunk=g_chunk)
    _equal(got, engine)


def test_emit_mode_raises():
    _, gp = _indexes(5)
    x, q, _, _ = _reference(np.float32, 5)
    with xp.set_options(selection_mode="emit"), pytest.raises(NotImplementedError, match="ROADMAP A4"):
        ps.selection_windowed_quantile(torch.from_numpy(x), gp.merge_plan, q)


def test_engine_resolution():
    """The backend is the data's device: the CPU selects by default, CUDA
    only under ``selection_on_tpu``; "auto" resolves to the gather mode and
    to the row sort's kernel for float32 on CUDA."""
    _, gp = _indexes(5)
    plan, q = gp.merge_plan, equally_spaced_nodes(5)
    assert ps.selection_ok(plan, q, "cpu") and not ps.selection_ok(plan, q, "cuda")
    with xp.set_options(selection_on_tpu=True):
        assert ps.selection_ok(plan, q, "cuda:0")
    with xp.set_options(selection_backend=False):
        assert not ps.selection_ok(plan, q, "cpu")
    assert not ps.selection_ok(plan, np.ones((2, 5)), "cpu")
    assert ps.default_mode() == "gather"
    assert ps.default_sort_impl(torch.float32, "cuda") == "pallas"
    assert ps.default_sort_impl(torch.float32, "cpu") == ps.default_sort_impl(torch.float64, "cuda") == "lax"
    with xp.set_options(selection_sort="xla"):
        assert ps.default_sort_impl(torch.float32, "cuda") == "xla"


# ------------------------------------------------------------- fused cores


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_train_adjust_matches_reference_bitwise(dtype):
    """``eqm_train_adjust_windowed`` with default options: the selection
    train (one stacked pass) and the adjust, against the reference's."""
    gj, gp = _indexes(31, years=4)
    T = 365 * 4
    ref, hist, sim = (_data(dtype, T, seed=s) + off for s, off in ((1, 0.0), (2, 2.0), (3, 3.0)))
    q = equally_spaced_nodes(15).astype(dtype)
    got = palgos.eqm_train_adjust_windowed(
        *(torch.from_numpy(a) for a in (ref, hist, sim)), gp.merge_plan, q, device_brackets(gp, "linear"), kind="+"
    )
    want = jalgos.eqm_train_adjust_windowed(ref, hist, sim, gj.merge_plan, q, jbrackets(gj, "linear"), kind="+")
    for g, w in zip(got, want):
        _equal(g, w)


# ------------------------------------------------------------- public API


def _pair(x, tj, tp):
    attrs = {"units": "K"}
    return xt.DataArray(x, ("site", "time"), {"time": tj}, attrs, "tas"), xp.DataArray(x, ("site", "time"), {"time": tp}, dict(attrs), "tas")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["+", "*"])
def test_public_windowed_eqm_matches_reference_bitwise(dtype, kind):
    """``EmpiricalQuantileMapping.train(group="time.dayofyear",
    window=31).adjust(interp="linear")`` with default options in both
    packages, numpy data with NaN gaps and an all-NaN site."""
    kw = dict(periods=365 * 6, freq="D", calendar="noleap")
    tj, tp = xt.date_range("2001-01-01", **kw), xp.date_range("2001-01-01", **kw)
    data = [np.abs(_data(dtype, 365 * 6, seed=s)) + off for s, off in ((11, 1.0), (12, 2.0), (13, 3.0))]
    (rj, rp), (hj, hp), (sj, sp) = (_pair(a, tj, tp) for a in data)
    train = dict(group="time.dayofyear", window=31, nquantiles=20, kind=kind)
    want = xt.EmpiricalQuantileMapping.train(rj, hj, **train)
    got = xp.EmpiricalQuantileMapping.train(rp, hp, **train)
    for name in ("af", "hist_q"):
        assert got.ds[name].data.device.type == "cpu"
        _equal(got.ds[name].data, want.ds[name].data)
    _equal(got.adjust(sp, interp="linear").data, want.adjust(sj, interp="linear").data)


def test_chip_smoke_selection_path_on_cpu():
    """``chip_smoke.py``'s selection phase on the CPU at a small size: the
    public windowed EQM on numpy inputs of the heavy recipe, finite and
    NaN-masked, equal to the reference and to the port's re-sort oracle."""
    from chip_smoke import heavy_problem, nan_masked, resort_oracle, run_windowed_path

    t, data = heavy_problem(6, 4)
    tj = xt.date_range("1950-01-01", periods=len(t), freq="D", calendar="noleap")
    mk = lambda x: xt.DataArray(x, ("site", "time"), {"time": tj}, {"units": "K"})  # noqa: E731
    for arrays in (data, nan_masked(data)):
        got = run_windowed_path(*arrays, t)
        assert got.device.type == "cpu" and got.dtype == torch.float32
        want = xt.EmpiricalQuantileMapping.train(mk(arrays[0]), mk(arrays[1]), group="time.dayofyear", window=31, nquantiles=50, kind="+")
        _equal(got, want.adjust(mk(arrays[2]), interp="linear").data)
        _equal(got, resort_oracle(*(torch.from_numpy(a) for a in arrays), t))
    masked = nan_masked(data)
    assert np.isnan(masked[0][:2]).all() and 0.05 < np.isnan(masked[0][2:6]).mean() < 0.15 and not np.isnan(masked[0][6:]).any()
