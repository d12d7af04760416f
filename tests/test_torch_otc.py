"""The port's optimal-transport pieces, ``OTC`` / ``dOTC`` and the SBCK
gateway against the JAX package, on the CPU.

The histograms, the costs, the exact plans (the port's own copy of the
network simplex) and the sampling are host float64 numpy in both packages:
given the same uniforms they equal each other exactly.  The uniforms come
from the JAX package's Threefry stream in these tests (the port's
``models.otc._group_draws`` and ``processing._adapt_freq_draws`` are
replaced), since a ``torch.Generator`` cannot reproduce it (ROADMAP C4).
Sinkhorn is PyTorch in the port and JAX in the reference: float64 at 1e-10.
"""

import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

import xsdba_tpu_torch as xp
from e2e_cases import JAX_SEED, build_inputs
from xsdba_tpu import native as jnative
from xsdba_tpu.models import otc as jotc
from xsdba_tpu.ops import ot as jot
from xsdba_tpu.utils.rng import next_key
from xsdba_tpu.utils.rng import seed as jax_seed
from xsdba_tpu_torch import native as tnative
from xsdba_tpu_torch import processing as tproc
from xsdba_tpu_torch.models import otc as totc
from xsdba_tpu_torch.models.sbck import generate_sbck_classes
from xsdba_tpu_torch.ops import ot as tot


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


FROZEN = os.path.join(os.path.dirname(__file__), "golden", "e2e_scen.npz")


@pytest.fixture
def reference_draws(monkeypatch):
    """The port's OT and frequency-adaptation draws made as the JAX package
    makes them: each group a ``_Draws`` on the stream's next key, each
    frequency adaptation two uniforms split from the next key.  Seed the
    JAX stream before each package's call."""

    def adapt_freq_draws(simg):
        k1, k2 = jax.random.split(next_key())
        u = lambda k, lo, hi: torch.from_numpy(np.array(jax.random.uniform(k, tuple(simg.shape), dtype=np.float64, minval=lo, maxval=hi)))  # noqa: E731
        return u(k1, 0.1, 0.25), u(k2, 0.0, 1.0)

    monkeypatch.setattr(totc, "_group_draws", lambda n: [jotc._Draws(next_key()) for _ in range(n)])
    monkeypatch.setattr(tproc, "_adapt_freq_draws", adapt_freq_draws)


def _clouds(seed, n=25, m=30):
    rng = np.random.default_rng(seed)
    mu, nu = rng.random(n) + 1e-3, rng.random(m) + 1e-3
    x, y = rng.normal(0, 1, (n, 2)), rng.normal(0.4, 1.1, (m, 2))
    return mu / mu.sum(), nu / nu.sum(), ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)


# ------------------------------------------------------------------- native


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emd_plans_equal_the_reference_solver(seed):
    mu, nu, C = _clouds(seed, 20 + 9 * seed, 31 - 4 * seed)
    np.testing.assert_array_equal(tnative.emd(mu, nu, C), jnative.emd(mu, nu, C))
    np.testing.assert_array_equal(tnative.emd_ssp(mu, nu, C), jnative.emd_ssp(mu, nu, C))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_emd_plan_is_optimal_by_the_other_solver(seed):
    """The network simplex's plan against successive shortest paths, an
    independent algorithm: both meet the marginals, and their costs agree to
    the summation's rounding (the optimal plan need not be unique, its cost
    is)."""
    mu, nu, C = _clouds(seed, 40 - 5 * seed, 17 + 6 * seed)
    plan, check = tnative.emd(mu, nu, C), tnative.emd_ssp(mu, nu, C)
    for p in (plan, check):
        assert (p >= 0).all()
        np.testing.assert_allclose(p.sum(axis=1), mu, rtol=0, atol=1e-10)
        np.testing.assert_allclose(p.sum(axis=0), nu, rtol=0, atol=1e-10)
    np.testing.assert_allclose((plan * C).sum(), (check * C).sum(), rtol=1e-10, atol=0)


def test_emd_library_is_built_into_the_build_directory(tmp_path, monkeypatch):
    lib = tnative.library_path()
    assert lib.exists() and lib.parent.name == "kernels" and "libxsdba_emd_" in lib.name
    assert lib.parent != tnative.SOURCE.parent
    # a source that does not compile raises, naming g++
    bad = tmp_path / "emd.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("XSDBA_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tnative._build(tnative.library_path())
    assert not any((tmp_path / "build").iterdir())


# ------------------------------------------------------------------- ops


def test_sinkhorn_plan_matches_reference():
    mu, nu, C = _clouds(3, 18, 22)
    want = np.asarray(jot.sinkhorn_plan(mu, nu, C, reg=5e-3, n_iter=300))
    got = tot.sinkhorn_plan(mu, nu, torch.from_numpy(C), reg=5e-3, n_iter=300)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_histogram_and_bin_width_equal_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (500, 2))
    np.testing.assert_array_equal(tot.bin_width_estimator(x), jot.bin_width_estimator(x))
    np.testing.assert_array_equal(tot.bin_width_estimator([x, 2 * x]), jot.bin_width_estimator([x, 2 * x]))
    flat = np.zeros((50, 1))
    np.testing.assert_array_equal(tot.bin_width_estimator(flat), jot.bin_width_estimator(flat))
    for a, b in zip(tot.histogram(x, np.array([0.3, 0.4]), np.array([0.1, 0.0])), jot.histogram(x, np.array([0.3, 0.4]), np.array([0.1, 0.0]))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("normalization", ["max_distance", "standardize", "max_value", None])
@pytest.mark.parametrize("solver", ["emd", "sinkhorn"])
def test_optimal_transport_matches_reference(normalization, solver):
    rng = np.random.default_rng(5)
    gx, gy = rng.normal(0, 1, (15, 2)) + 3, rng.normal(0.5, 1, (17, 2)) + 3
    mx, my = rng.random(15), rng.random(17)
    mx, my = mx / mx.sum(), my / my.sum()
    want = jot.optimal_transport(gx, gy, mx, my, normalization=normalization, solver=solver)
    got = tot.optimal_transport(gx, gy, mx, my, normalization=normalization, solver=solver)
    if solver == "emd":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_eps_cholesky_equals_reference():
    M = np.array([[1.0, 1.0], [1.0, 1.0]])            # singular: perturbed
    np.testing.assert_array_equal(tot.eps_cholesky(M), jot.eps_cholesky(M))
    with pytest.raises(ValueError, match="cov_factor"):
        tot.eps_cholesky(np.array([[1.0, 2.0], [2.0, 1.0]]), nit=2)


# ------------------------------------------------------------- OTC / dOTC


def _bivariate(mod, seed, mean, n=730, start="2000-01-01"):
    rng = np.random.default_rng(seed)
    t = mod.date_range(start, periods=n, freq="D", calendar="noleap")
    tas = rng.normal(280 + mean, 2, n)
    pr = np.where(rng.random(n) < 0.4, 0.0, rng.gamma(2, 2 + mean / 4, n))
    return mod.processing.stack_variables(mod.Dataset({
        "tas": mod.DataArray(tas, ("time",), {"time": t}, {"units": "K"}, "tas"),
        "pr": mod.DataArray(pr, ("time",), {"time": t}, {"units": "mm/d"}, "pr"),
    }))


@pytest.fixture(scope="module")
def mv():
    import xsdba_tpu as xt

    return {m: {k: _bivariate(mod, s, mean, start=st) for k, s, mean, st in (("ref", 1, 0, "2000-01-01"), ("hist", 2, 2, "2000-01-01"), ("sim", 3, 4, "2050-01-01"))}
            for m, mod in (("jax", xt), ("port", xp))}


def _both(reference_draws, cls, kw, mv, with_sim):
    import xsdba_tpu as xt

    out = []
    for mod, d in ((xt, mv["jax"]), (xp, mv["port"])):
        jax_seed(JAX_SEED)
        args = (d["ref"], d["hist"], d["sim"]) if with_sim else (d["ref"], d["hist"])
        out.append(getattr(mod, cls).adjust(*args, **kw))
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(bin_width={"tas": 0.5}, group="time.month", jitter_inside_bins=False),
    dict(adapt_freq_thresh={"pr": "1 mm/d"}, bin_width=[0.5, 1.0], bin_origin={"pr": 0.1}),
    dict(solver="sinkhorn", bin_width=1.0, normalization="standardize"),
], ids=["defaults", "monthly", "adapt_freq", "sinkhorn"])
def test_otc_matches_reference(reference_draws, mv, kw):
    want, got = _both(reference_draws, "OTC", kw, mv, with_sim=False)
    assert isinstance(got.data, torch.Tensor) and got.data.dtype == torch.float64 and got.dims == want.dims
    if kw.get("solver") == "sinkhorn":
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=0, atol=1e-10)
    else:
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.attrs["bias_adjustment"].startswith("OTC.adjust")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(kind={"pr": "*"}, cov_factor="std", group="time.month"),
    dict(kind={"pr": "*"}, cov_factor="cholesky", bin_width=0.7, adapt_freq_thresh={"pr": "1 mm/d"}),
    dict(cov_factor=None, jitter_inside_bins=False, bin_width={"pr": 1.0}),
], ids=["defaults", "mult_std_monthly", "cholesky_adapt_freq", "no_rescale"])
def test_dotc_matches_reference(reference_draws, mv, kw):
    want, got = _both(reference_draws, "dOTC", kw, mv, with_sim=True)
    assert isinstance(got.data, torch.Tensor) and got.dims == want.dims
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


def test_otc_refuses_sim(mv):
    d = mv["port"]
    with pytest.raises(ValueError, match="does not take a `sim`"):
        xp.OTC.adjust(d["ref"], d["hist"], d["sim"])


def test_port_draws_come_from_its_stream(mv):
    """Without injected draws the port draws from ``utils/rng.py``: the
    same seed gives the same output, another seed another one, and the
    output has the moments of the JAX package's output on its own draws."""
    import xsdba_tpu as xt

    d = mv["port"]
    runs = []
    for s in (5, 5, 6):
        xp.utils.rng.seed(s)
        runs.append(xp.OTC.adjust(d["ref"], d["hist"], group="time.month").data.numpy())
    np.testing.assert_array_equal(runs[0], runs[1])
    assert (runs[0] != runs[2]).any()
    jax_seed(1)
    want = np.asarray(xt.OTC.adjust(mv["jax"]["ref"], mv["jax"]["hist"], group="time.month").data)
    np.testing.assert_allclose(runs[0].mean(axis=1), want.mean(axis=1), atol=0.1)
    np.testing.assert_allclose(runs[0].std(axis=1), want.std(axis=1), rtol=0.05)


def test_e2e_cases_match_frozen(reference_draws):
    """The ``OTC`` and ``dOTC`` cases of ``tests/e2e_cases.py`` replayed
    through the port with the reference's draws."""
    frozen = np.load(FROZEN)
    d = {k: _port_mv(v) for k, v in build_inputs().items() if k.startswith("mv_")}
    jax_seed(JAX_SEED)
    scen = xp.OTC.adjust(d["mv_ref"], d["mv_hist"], bin_width=0.5)
    np.testing.assert_allclose(scen.data.numpy(), frozen["OTC"], rtol=1e-9, atol=1e-9)
    jax_seed(JAX_SEED)
    scen = xp.dOTC.adjust(d["mv_ref"], d["mv_hist"], d["mv_sim"], bin_width=0.5)
    np.testing.assert_allclose(scen.data.numpy(), frozen["dOTC"], rtol=1e-9, atol=1e-9)


def _port_mv(da):
    t = da.coords["time"]
    time = xp.date_range(f"{int(t.year[0]):04d}-{int(t.month[0]):02d}-{int(t.day[0]):02d}", periods=len(t), freq="D", calendar=t.calendar)
    coords = {"time": time, "multivar": np.asarray(da.coords["multivar"])}
    return xp.DataArray(torch.as_tensor(np.array(da.data)), da.dims, coords, dict(da.attrs), da.name)


# -------------------------------------------------------------------- SBCK


class _FakeQM:
    """A stand-in with SBCK's fit/predict convention ([time, variables])."""

    def __init__(self, delta: float = 0.0):
        self.delta = delta

    def fit(self, Y0, X0, X1):
        self.shift = np.mean(Y0, axis=0) - np.mean(X0, axis=0)

    def predict(self, X1):
        return X1 + self.shift + self.delta


@pytest.fixture
def fake_sbck(monkeypatch):
    mod = types.ModuleType("SBCK")
    mod.QM = _FakeQM
    mod.NotAModel = type("NotAModel", (), {})
    monkeypatch.setitem(sys.modules, "SBCK", mod)
    return mod


def test_sbck_missing_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "SBCK", None)
    with pytest.raises(ImportError, match="SBCK"):
        generate_sbck_classes()


def test_sbck_gateway_wraps_fit_predict_classes(fake_sbck):
    from xsdba_tpu.models.sbck import generate_sbck_classes as ref_generate

    classes = dict(generate_sbck_classes())
    assert set(classes) == {"SBCK_QM"} == set(dict(ref_generate()))
    rng = np.random.default_rng(7)
    t = xp.date_range("2000-01-01", periods=365, freq="D", calendar="noleap")
    mk = lambda v, dims: xp.DataArray(torch.from_numpy(v), dims, {"time": t}, {"units": "K"}, "tas")  # noqa: E731
    ref, hist, sim = (rng.normal(m, 1, (2, 365)) for m in (10, 12, 13))
    uni = classes["SBCK_QM"].adjust(mk(ref, ("site", "time")), mk(hist, ("site", "time")), mk(sim, ("site", "time")), delta=0.5)
    want = sim + ref.mean(axis=1, keepdims=True) - hist.mean(axis=1, keepdims=True) + 0.5
    assert isinstance(uni.data, torch.Tensor) and uni.dims == ("site", "time")
    np.testing.assert_allclose(uni.data.numpy(), want, rtol=1e-12)
    multi = classes["SBCK_QM"].adjust(*(mk(a, ("multivar", "time")) for a in (ref, hist, sim)), multi_dim="multivar")
    np.testing.assert_allclose(multi.data.numpy(), want - 0.5, rtol=1e-12)
    assert "bias_adjustment" in multi.attrs
