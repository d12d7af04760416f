"""Signs of zero through the port's value sorts against the JAX package, on
the CPU (ROADMAP C29).

The reference sorts with ``jnp.sort``, which is stable and compares -0.0
equal to +0.0, so ±0.0 ties keep their input order and a quantile that
falls on a zero takes its sign from the same element.  ``==`` and
``assert_array_equal`` treat -0.0 as equal to +0.0, so these tests compare
bit patterns: equal under ``==`` and equal in ``np.signbit`` (any NaN equal
to any NaN).  The inputs are rows half +0.0 and half -0.0, in random
order, with some normal values among them, through the reference's
compiled functions (64-bit mode on, as ``tests/conftest.py`` sets it):
``nan_quantile``, ``vecquantiles``, ``nbutils.quantile`` and QDM's train,
whose ``kind="*"`` factors divide by quantiles of zero and so come out
+inf or -inf by the sign of the zero.
"""

import jax
import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu.nbutils as jnb
import xsdba_tpu_torch as xp
from xsdba_tpu_torch import nbutils as tnb
from xsdba_tpu.ops import quantile as jquant
from xsdba_tpu_torch.ops import quantile as tquant


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


def _np(a):
    a = a.data if hasattr(a, "data") and not isinstance(a, (np.ndarray, torch.Tensor)) else a
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same_bits(got, want):
    """``==`` (NaN equal to NaN) and the same sign of every zero."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    both_nan = np.isnan(got) & np.isnan(want)
    assert ((got == want) | both_nan).all(), f"{int((~((got == want) | both_nan)).sum())} values differ"
    signs = (np.signbit(got) != np.signbit(want)) & ~both_nan
    assert not signs.any(), f"{int(signs.sum())} of {got.size} values differ in sign"


def zero_rows(shape, dtype, seed, every=7):
    """Rows half +0.0 and half -0.0 in random order, every ``every``-th value
    normal, a few NaN."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.random(shape) < 0.5, 0.0, -0.0).astype(dtype)
    x[..., ::every] = rng.normal(0, 1, x[..., ::every].shape)
    x[rng.random(shape) < 0.02] = np.nan
    return x


_jit_nan_quantile = jax.jit(jquant.nan_quantile, static_argnames=("axis", "alpha", "beta"))
_jit_vecquantiles = jax.jit(jquant.vecquantiles, static_argnames=("axis", "alpha", "beta"))
Q = np.linspace(0.0, 1.0, 11)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("every", [7, 3])
def test_nan_quantile_keeps_the_sign_of_zero(dtype, every):
    x = zero_rows((200, 30), dtype, seed=every, every=every)
    got = tquant.nan_quantile(torch.as_tensor(x), torch.as_tensor(Q, dtype=torch.float64))
    assert_same_bits(got, _jit_nan_quantile(x, Q.astype(dtype)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_vecquantiles_keeps_the_sign_of_zero(dtype):
    x = zero_rows((300, 40), dtype, seed=5)
    rng = np.random.default_rng(6)
    ranks = rng.choice(Q, 300).astype(dtype)
    ranks[::17] = np.nan
    got = tquant.vecquantiles(torch.as_tensor(x), torch.as_tensor(ranks))
    assert_same_bits(got, _jit_vecquantiles(x, ranks))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nbutils_quantile_keeps_the_sign_of_zero(dtype):
    x = zero_rows((60, 100), dtype, seed=8)
    got = tnb.quantile(x, Q, -1)
    want = jnb.quantile(x, Q, -1)
    assert_same_bits(got, want)


def _qdm_inputs(dtype, zeros=(0.3, 0.45), seed=11):
    """Three sites x 12 noleap years of daily values, ``zeros`` of them
    ±0.0 (half each) in ref and in hist, as dry days of pr are: hist is
    drier, so some of its quantiles are zeros where ref's are not."""
    rng = np.random.default_rng(seed)
    n = 365 * 12
    ref, hist, sim = (rng.gamma(2.0, 2.0, (3, n)).astype(dtype) for _ in range(3))
    for a, frac in zip((ref, hist), zeros):
        dry = rng.random(a.shape) < frac
        a[dry] = np.where(rng.random(int(dry.sum())) < 0.5, 0.0, -0.0)
    return ref, hist, sim


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["+", "*"])
def test_qdm_train_keeps_the_sign_of_zero(dtype, kind):
    """``hist_q`` and ``af`` of QDM trained on data 30–45 % ±0.0: the same bits
    as the reference, signs of zero and (``kind="*"``) the ±inf factors of
    a zero quantile included."""
    ref, hist, _ = _qdm_inputs(dtype)
    out = {}
    for mod in (xt, xp):
        t = mod.date_range("2000-01-01", periods=ref.shape[-1], freq="D", calendar="noleap")
        da = lambda a, name: mod.DataArray(a, ("site", "time"), {"time": t}, {"units": "mm/d"}, name)  # noqa: E731
        out[mod] = mod.QuantileDeltaMapping.train(da(ref, "ref"), da(hist, "hist"), kind=kind, group="time.month", nquantiles=15)
    for name in ("hist_q", "af"):
        assert_same_bits(out[xp].ds[name].data, out[xt].ds[name].data)
    af = _np(out[xt].ds["af"].data)
    zero_q = _np(out[xt].ds["hist_q"].data) == 0
    assert zero_q.any() and np.signbit(_np(out[xt].ds["hist_q"].data)[zero_q]).any()
    if kind == "*":
        # the inputs give factors of both signs of infinity
        assert np.isposinf(af).any() and np.isneginf(af).any()


# the port's other value sorts whose sorted values reach an output


def test_reordering_core_keeps_the_sign_of_zero():
    from xsdba_tpu import processing as jproc
    from xsdba_tpu_torch import processing as tproc

    rng = np.random.default_rng(12)
    ref = rng.normal(0, 1, (20, 90))
    sim = zero_rows((20, 90), np.float64, seed=13)
    got = tproc._reordering_core(torch.as_tensor(ref), torch.as_tensor(sim))
    assert_same_bits(got, jax.jit(jproc._reordering_core)(ref, sim))


def test_sort_along_dim_keeps_the_sign_of_zero():
    x = zero_rows((4, 365), np.float64, seed=14)
    out = {}
    for mod in (xt, xp):
        t = mod.date_range("2000-01-01", periods=365, freq="D", calendar="noleap")
        out[mod] = mod.processing.sort_along_dim(mod.DataArray(x, ("site", "time"), {"time": t}, {"units": "mm/d"}, "pr"), "time")
    assert_same_bits(out[xp].data, out[xt].data)


@pytest.mark.parametrize("n", [30, 31])
def test_loess_nanmedian_keeps_the_sign_of_zero(n):
    """The LOESS robustness weights' median: the middle pair of ±0.0 ties
    averaged, its sign from the elements the stable sort puts there."""
    from xsdba_tpu_torch.ops.loess import _nanmedian

    x = zero_rows((300, n), np.float64, seed=n, every=11)
    want = jax.jit(lambda a: jax.numpy.nanmedian(a, axis=-1, keepdims=True))(x)
    assert_same_bits(_nanmedian(torch.as_tensor(x)), want)
