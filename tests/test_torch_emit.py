"""The port's emit engine (``ops/selquant.py`` mode "emit",
``ops/cuda/emit_kernel.py``) against the JAX package's emit engine, on the
CPU, where the port runs the kernel's plain twin.

Every comparison is bit for bit: ``assert_array_equal`` (NaN equal to NaN)
and the same bit patterns, so that a selected -0.0 comes back +0.0 in both
packages.  Covered: windows 5 and 31, float32 and float64, finite data,
15 % NaN, an all-NaN site and ties; shuffled quantiles; alpha and beta
other than 1; slot windows small enough that the overflow reroute fires;
block and chunk sizes; concentrated zeros of both signs; the port's gather
engine against its emit engine; a hit budget small enough to cut every
piece; and the public windowed EQM and QDM under ``selection_mode="emit"``
in both packages.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu.ops import selquant as js
from xsdba_tpu_torch.ops import selquant as ps
from xsdba_tpu_torch.ops.correction import equally_spaced_nodes
from xsdba_tpu_torch.ops.cuda import emit_kernel

YEARS = 4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    ints = np.int32 if got.dtype == np.float32 else np.int64
    np.testing.assert_array_equal(got.view(ints), want.view(ints))


@functools.lru_cache(maxsize=None)
def _indexes(window, years=YEARS):
    kw = dict(periods=365 * years, freq="D", calendar="noleap")
    gj = xt.Grouper("time.dayofyear", window=window).indexes(xt.date_range("1980-01-01", **kw))
    gp = xp.Grouper("time.dayofyear", window=window).indexes(xp.date_range("1980-01-01", **kw))
    return gj, gp


def _data(dtype, T, seed=7):
    """Four sites: finite, 15 % NaN, all NaN, and finite with ties."""
    rng = np.random.default_rng(seed)
    x = rng.normal(10, 3, (4, T))
    x[1, rng.random(T) < 0.15] = np.nan
    x[2] = np.nan
    x[3] = np.round(x[3])
    return x.astype(dtype)


def _wet_days(dtype, T, seed=9):
    """Precipitation-like sites: most days exactly zero, of either sign
    (the ties concentrate a group's ranks in one chunk), the rest gamma."""
    rng = np.random.default_rng(seed)
    x = rng.gamma(0.6, 4.0, (3, T))
    dry = rng.random((3, T)) < 0.7
    x[dry] = np.where(rng.random(int(dry.sum())) < 0.5, 0.0, -0.0)
    x[2, rng.random(T) < 0.1] = np.nan
    return x.astype(dtype)


def _both(x, window, q, **kw):
    """(port, reference) emit results of the same call."""
    gj, gp = _indexes(window)
    want = np.asarray(js.selection_windowed_quantile(jnp.asarray(x), gj.merge_plan, np.asarray(q), mode="emit", **kw))
    got = ps.selection_windowed_quantile(torch.from_numpy(x), gp.merge_plan, q, mode="emit", **kw)
    return got, want


@pytest.mark.parametrize("window", [5, 31])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_emit_matches_reference_and_gather_bitwise(dtype, window):
    x = _data(dtype, 365 * YEARS)
    q = equally_spaced_nodes(20).astype(dtype)
    got, want = _both(x, window, q)
    assert got.dtype == torch.from_numpy(x).dtype and tuple(got.shape) == (4, 365, 20)
    _same_bits(got, want)
    _same_bits(got, ps.selection_windowed_quantile(torch.from_numpy(x), _indexes(window)[1].merge_plan, q, mode="gather"))
    assert bool(torch.isnan(got[2]).all()) and not bool(torch.isnan(got[[0, 1, 3]]).any())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_emit_on_shuffled_quantiles(dtype):
    x = _data(dtype, 365 * YEARS, seed=5)
    q = np.random.default_rng(0).permutation(equally_spaced_nodes(17)).astype(dtype)
    got, want = _both(x, 31, q)
    _same_bits(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("alpha,beta", [(0.4, 0.4), (0.0, 1.0), (1.0 / 3, 1.0 / 3)])
def test_emit_alpha_beta(dtype, alpha, beta):
    x = _data(dtype, 365 * YEARS, seed=3)
    q = equally_spaced_nodes(12).astype(dtype)
    got, want = _both(x, 31, q, alpha=alpha, beta=beta)
    _same_bits(got, want)


@pytest.mark.parametrize("slots,width", [(1, 40), (2, 40), (32, 32), (64, 40)])
def test_emit_slots_and_the_overflow_reroute(monkeypatch, slots, width):
    """Chunks of 32 values: some need two of the 40 ranks of a group, so
    ``slots`` of 1 or 2 overflow and the emission reruns at nq = 40 slots,
    as the reference's ``lax.cond`` does; 32 slots suffice; ``slots`` >= nq
    runs at nq at once.  Every result is the same."""
    widths = []
    real = emit_kernel._slots
    monkeypatch.setattr(emit_kernel, "_slots", lambda rk, kb, S: widths.append(S) or real(rk, kb, S))
    x = _data(np.float32, 365 * YEARS, seed=21)
    q = equally_spaced_nodes(40).astype(np.float32)
    got, want = _both(x, 31, q, slots=slots, Wb=8, nb_chunk=4)
    _same_bits(got, want)
    assert set(widths) == {width}


@pytest.mark.parametrize("Wb,nb_chunk", [(8, 4), (16, 8), (32, 1), (128, 64)])
def test_emit_block_and_chunk_sizes(Wb, nb_chunk):
    x = _data(np.float32, 365 * YEARS, seed=13)
    q = equally_spaced_nodes(20).astype(np.float32)
    got, want = _both(x, 5, q, Wb=Wb, nb_chunk=nb_chunk, slots=4)
    _same_bits(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_emit_on_concentrated_signed_zeros(dtype):
    """70 % of the days exactly +-0.0: the ranks of most groups crowd into
    one chunk, ``slots=2`` overflows, and every selected zero is +0.0."""
    x = _wet_days(dtype, 365 * YEARS)
    q = equally_spaced_nodes(20).astype(dtype)
    got, want = _both(x, 31, q, Wb=16, nb_chunk=8, slots=2)
    _same_bits(got, want)
    zeros = got[got == 0]
    assert zeros.numel() > 0 and not bool(torch.signbit(zeros).any())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_emit_within_a_small_hit_budget(monkeypatch, dtype):
    """The twin cuts its hit tensors over sites and groups; a budget of one
    chunk's worth of elements cuts every piece to one site and a few groups
    and changes no result."""
    x = _data(dtype, 365 * YEARS, seed=17)
    q = equally_spaced_nodes(10).astype(dtype)
    kw = dict(Wb=16, nb_chunk=4, slots=4)
    full = _both(x, 31, q, **kw)[0]
    monkeypatch.setattr(emit_kernel, "_HIT_BUDGET", 64 * 4 * 3)
    got, want = _both(x, 31, q, **kw)
    _same_bits(got, want)
    _same_bits(got, full)


def test_emit_twin_on_rows_without_valid_values():
    """Ranks no element reaches (an all-NaN row) read 0, the kernel's
    zeroed outputs; the wrapper takes the twin for CPU tensors."""
    svals = torch.full((2, 16), torch.nan)
    svals[1, :4] = torch.tensor([-0.0, 1.0, 2.0, 3.0])
    slab = torch.full((2, 16), 0, dtype=torch.int32)
    slab[1, :4] = 2                                                 # start 0, length 2: groups 0 and 1
    n = torch.tensor([[0, 0], [4, 4]], dtype=torch.int32)
    clo = torch.zeros((2, 2, 2), dtype=torch.int32)
    clo[1, 1] = 4
    rk = torch.tensor([[[1, 1], [1, 1]], [[1, 2], [3, 4]]], dtype=torch.int32)
    left, right, maxv = emit_kernel.emit(svals, slab, clo, rk, rk, n, 8, slots=1)
    assert emit_kernel.launches == 0
    _same_bits(left[0], np.zeros((2, 2), np.float32))
    _same_bits(maxv, np.array([[0, 0], [3, 3]], np.float32))
    _same_bits(left[1], np.array([[0, 1], [2, 3]], np.float32))


def test_emit_wrapper_checks_its_operands():
    svals, slab = torch.zeros(2, 16), torch.zeros(2, 16, dtype=torch.int32)
    clo, rk, n = torch.zeros(2, 2, 3, dtype=torch.int32), torch.ones(2, 3, 4, dtype=torch.int32), torch.ones(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="divide"):
        emit_kernel.emit(svals, slab, clo, rk, rk, n, 5)
    with pytest.raises(TypeError, match="int32"):
        emit_kernel.emit(svals, slab.long(), clo, rk, rk, n, 8)
    with pytest.raises(TypeError, match="float32 or float64"):
        emit_kernel.emit(svals.half(), slab, clo, rk, rk, n, 8)
    with pytest.raises(ValueError, match="clo must be"):
        emit_kernel.emit(svals, slab, clo[:, :1], rk, rk, n, 8)


def test_emit_mode_option():
    """``selection_mode="emit"`` selects emit on either device; "auto"
    resolves as the reference resolves it per backend: gather on the CPU,
    emit on CUDA (checked by the device it is given, with no card)."""
    assert ps.default_mode("cpu") == ps.default_mode(torch.device("cpu")) == "gather"
    assert ps.default_mode("cuda") == ps.default_mode(torch.device("cuda", 0)) == "emit"
    with xp.set_options(selection_mode="gather"):
        assert ps.default_mode("cuda") == "gather"
    with xp.set_options(selection_mode="emit"):
        assert ps.default_mode("cpu") == "emit"
        _, gp = _indexes(5)
        x = _data(np.float32, 365 * YEARS)
        q = equally_spaced_nodes(8).astype(np.float32)
        got = ps.selection_windowed_quantile(torch.from_numpy(x), gp.merge_plan, q)
    _same_bits(got, ps.selection_windowed_quantile(torch.from_numpy(x), gp.merge_plan, q, mode="gather"))


def test_auto_takes_gather_on_cpu_data(monkeypatch):
    """"auto" on CPU data is the gather engine, as in the reference: the
    emission's twin is never called, and the result is the reference's
    gather result bit for bit."""
    calls = []
    real = emit_kernel.emit_reference
    monkeypatch.setattr(emit_kernel, "emit_reference", lambda *a, **k: calls.append(1) or real(*a, **k))
    gj, gp = _indexes(31)
    x = _data(np.float32, 365 * YEARS)
    q = equally_spaced_nodes(8).astype(np.float32)
    got = ps.selection_windowed_quantile(torch.from_numpy(x), gp.merge_plan, q)
    assert not calls
    _same_bits(got, js.selection_windowed_quantile(jnp.asarray(x), gj.merge_plan, q, mode="gather"))


# ------------------------------------------------------------- public API


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("cls", ["EmpiricalQuantileMapping", "QuantileDeltaMapping"])
def test_public_windowed_call_under_emit_matches_reference_bitwise(monkeypatch, cls, kind, dtype):
    """``train(group="time.dayofyear", window=31).adjust(interp="linear")``
    under ``selection_mode="emit"`` in both packages, numpy data with NaN
    gaps and an all-NaN site; the port's train goes through the emission."""
    calls = []
    real = emit_kernel.emit_reference
    monkeypatch.setattr(emit_kernel, "emit_reference", lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(periods=365 * YEARS, freq="D", calendar="noleap")
    tj, tp = xt.date_range("2001-01-01", **kw), xp.date_range("2001-01-01", **kw)
    data = [np.abs(_data(dtype, 365 * YEARS, seed=s)) + off for s, off in ((11, 1.0), (12, 2.0), (13, 3.0))]
    attrs = {"units": "K"}
    train = dict(group="time.dayofyear", window=31, nquantiles=15, kind=kind)
    out = {}
    for mod, t in ((xt, tj), (xp, tp)):
        das = [mod.DataArray(a, ("site", "time"), {"time": t}, dict(attrs), "tas") for a in data]
        with mod.set_options(selection_mode="emit"):
            trained = getattr(mod, cls).train(das[0], das[1], **train)
            out[mod] = trained, trained.adjust(das[2], interp="linear")
    assert calls
    for name in ("af", "hist_q"):
        _same_bits(out[xp][0].ds[name].data, out[xt][0].ds[name].data)
    _same_bits(out[xp][1].data, out[xt][1].data)
