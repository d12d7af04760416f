"""Two error paths of the port's adjust against the JAX package, on the CPU.

- ROADMAP C25: trained arrays broadcast against sim's leading dims by
  position from the right, in both packages, so tables trained on
  [site, time] fail against a ``stack_periods`` sim laid out as
  [site, period, time].  The port keeps that rule (its outputs stay the
  reference's) and raises the reference's ``ValueError``, whose message
  names the fix: ``sim.transpose("period", ...)``.  With the period dim
  first, the same adjust runs.
- ROADMAP C30: a cubic lookup in tables narrower than 3 columns raises the
  reference's ``ValueError`` before the spline's solve.
"""

import warnings

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu.ops import interp as J
from xsdba_tpu_torch.ops import interp as T


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


SITES, YEARS = 2, 12
FIX = r'sim\.transpose\("period", \.\.\.\)'

# (class, train keywords, adjust keywords): every adjust whose trained
# arrays meet sim's leading dims
CASES = {
    "EQM monthly": ("EmpiricalQuantileMapping", dict(group="time.month", nquantiles=10, kind="+"), dict(interp="linear")),
    "EQM dayofyear+31": ("EmpiricalQuantileMapping", dict(group="time.dayofyear", window=31, nquantiles=10, kind="+"), dict(interp="linear")),
    "EQM cubic": ("EmpiricalQuantileMapping", dict(group="time.month", nquantiles=10, kind="+"), dict(interp="cubic")),
    "QDM monthly": ("QuantileDeltaMapping", dict(group="time.month", nquantiles=10, kind="*"), dict(interp="linear")),
    "QDM time": ("QuantileDeltaMapping", dict(group="time", nquantiles=10, kind="+"), dict(interp="linear")),
    "QDM seasonal nearest": ("QuantileDeltaMapping", dict(group="time.season", nquantiles=10, kind="+"), dict(interp="nearest")),
    "DQM monthly": ("DetrendedQuantileMapping", dict(group="time.month", nquantiles=10, kind="+"), dict(interp="linear")),
    "Scaling": ("Scaling", dict(group="time.month", kind="+"), dict()),
    "LOCI": ("LOCI", dict(group="time.month", thresh="1 mm/d"), dict()),
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.gamma(2.0, 2.0, (SITES, 365 * YEARS)) for _ in range(3))


def _trained_and_stacked(mod, name, train_kw):
    ref, hist, sim = _inputs()
    t = mod.date_range("2000-01-01", periods=365 * YEARS, freq="D", calendar="noleap")
    da = lambda a, n: mod.DataArray(a, ("site", "time"), {"time": t}, {"units": "mm/d"}, n)  # noqa: E731
    trained = getattr(mod, name).train(da(ref, "ref"), da(hist, "hist"), **train_kw)
    stacked = mod.processing.stack_periods(da(sim, "sim"), window=4, stride=4)
    assert stacked.dims == ("site", "period", "time") and stacked.shape[:2] == (SITES, 3)
    return trained, stacked


@pytest.mark.parametrize("case", list(CASES))
def test_stacked_sim_error_names_the_fix(case):
    name, train_kw, adjust_kw = CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtrained, jstacked = _trained_and_stacked(xt, name, train_kw)
        with pytest.raises(ValueError):
            jtrained.adjust(jstacked, **adjust_kw)
        trained, stacked = _trained_and_stacked(xp, name, train_kw)
        with pytest.raises(ValueError, match=FIX):
            trained.adjust(stacked, **adjust_kw)
        # the fix: the period dim first, and the adjust runs as the reference's
        got = trained.adjust(stacked.transpose("period", "site", "time"), **adjust_kw)
        want = jtrained.adjust(jstacked.transpose("period", "site", "time"), **adjust_kw)
    assert got.dims == want.dims == ("period", "site", "time")
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-10, atol=1e-10)


def test_extremes_stacked_sim_error_names_the_fix():
    ref, hist, sim = _inputs(1)
    t = xp.date_range("2000-01-01", periods=365 * YEARS, freq="D", calendar="noleap")
    da = lambda a, n: xp.DataArray(a, ("site", "time"), {"time": t}, {"units": "mm/d"}, n)  # noqa: E731
    ev = xp.ExtremeValues.train(da(ref, "ref"), da(hist, "hist"), cluster_thresh="1 mm/d", q_thresh=0.95)
    stacked = xp.processing.stack_periods(da(sim, "sim"), window=4, stride=4)
    with pytest.raises(ValueError, match=FIX):
        ev.adjust(stacked, stacked, frac=0.7, power=3)


def test_leading_dims_check_passes_what_broadcasts():
    """What broadcasts by position goes through: equal dims, a dim of one,
    and a leading dim the trained arrays lack."""
    from xsdba_tpu_torch.utils.tensor import _check_leading

    for values, trained in (((3, 2), (3, 2)), ((3, 2), (2,)), ((4, 1), (7,)), ((), ()), ((5,), ())):
        _check_leading(values, trained)
    with pytest.raises(ValueError, match=FIX):
        _check_leading((2, 3), (2,))


@pytest.mark.parametrize("nq", [1, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cubic_on_narrow_tables_raises_the_reference_class(nq, dtype):
    rng = np.random.default_rng(nq)
    xq = np.sort(rng.normal(size=(3, nq)), axis=-1).astype(dtype)
    yq = rng.normal(size=(3, nq)).astype(dtype)
    v = rng.normal(size=(3, 10)).astype(dtype)
    with pytest.raises(Exception) as want:
        J.interp1d_table(v, xq, yq, method="cubic")
    with pytest.raises(ValueError, match="at least 3 nodes") as got:
        T.interp1d_table(torch.as_tensor(v), torch.as_tensor(xq), torch.as_tensor(yq), method="cubic")
    assert isinstance(got.value, want.type) and want.type is ValueError


@pytest.mark.parametrize("group", ["time.month", "time"])
def test_cubic_adjust_on_two_quantiles_raises_the_reference_class(group):
    ref, hist, sim = _inputs(2)
    errors = {}
    for mod in (xt, xp):
        t = mod.date_range("2000-01-01", periods=365 * YEARS, freq="D", calendar="noleap")
        da = lambda a, n: mod.DataArray(a, ("site", "time"), {"time": t}, {"units": "K"}, n)  # noqa: E731
        eqm = mod.EmpiricalQuantileMapping.train(da(ref, "ref"), da(hist, "hist"), group=group, nquantiles=2, kind="+")
        with pytest.raises(Exception) as err:
            eqm.adjust(da(sim, "sim"), interp="cubic")
        errors[mod] = err.type
    assert errors[xp] is errors[xt] is ValueError
