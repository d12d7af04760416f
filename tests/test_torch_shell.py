"""The port's shell modules against the JAX package's, on the CPU.

The alias modules (``options``, ``typing``, ``formatting``, ``units``,
``loess``, ``adjustment``, ``base``) resolve the JAX alias modules' names,
each to the port's own object; ``nbutils``, ``base.map_groups``, the
``testing`` factories, ``ops/layout.py``, ``utils/profiling.py``, the CLI and
``native.have_native`` take the same seeded numpy inputs as the JAX package's.

Tolerances.  ``nbutils`` moves values and does the type-7 arithmetic
unfused, as the reference's eager calls do, so it is held under ``==`` in
float64 and float32, NaN rows included; the factories and the swap move or
draw values and are held under ``==``; ``map_groups``' mean and std sum in
another order, 1e-12 relative (float64).  The selftest's residual is a mean
of 1095 float64 differences, 1e-6.
"""

import importlib
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
import xsdba_tpu.base as jbase  # not `from xsdba_tpu import base`: that finds models.base (ROADMAP C27)
import xsdba_tpu.nbutils as jnb
import xsdba_tpu.testing as jtesting
from xsdba_tpu.ops.layout import aligned_swap_last2 as jax_swap
from xsdba_tpu_torch import base as tbase
from xsdba_tpu_torch import cli, native
from xsdba_tpu_torch import nbutils as tnb
from xsdba_tpu_torch import testing as ttesting
from xsdba_tpu_torch.ops.layout import aligned_swap_last2 as torch_swap
from xsdba_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


def _np(x):
    x = getattr(x, "data", x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _names(mod):
    """The public names a module resolves: not private, not a module."""
    return {n for n in dir(mod) if not n.startswith("_") and n != "annotations" and not isinstance(getattr(mod, n), type(np))}


# each alias module, the port's modules its re-exports come from (first
# match), and the names the alias defines itself
ALIASES = {
    "options": (("utils.options",), ()),
    "typing": (("utils.typing",), ()),
    "formatting": (("utils.formatting",), ()),
    "units": (("utils.units",), ("units",)),
    "loess": (("ops.loess",), ()),
    "adjustment": (("models", "models.sbck"), ()),
    "base": (("processing", "utils", "utils.container", "utils.grouper", "utils.params", "utils.calendar"),
             ("uniform_calendars", "uses_dask", "ensure_chunk_size", "duck_empty", "map_blocks", "map_groups", "max_doy")),
}


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_alias_module_resolves_the_reference_names(alias):
    """Exactly the JAX alias module's names (``options`` adds the port's
    ``DEVICE``), each re-export the port's own object."""
    jmod, tmod = importlib.import_module(f"xsdba_tpu.{alias}"), importlib.import_module(f"xsdba_tpu_torch.{alias}")
    assert _names(tmod) == _names(jmod) | ({"DEVICE"} if alias == "options" else set())
    sources, own = ALIASES[alias]
    sources = [importlib.import_module(f"xsdba_tpu_torch.{s}") for s in sources]
    for n in sorted(_names(tmod) - set(own)):
        src = next(m for m in sources if hasattr(m, n))
        assert getattr(tmod, n) is getattr(src, n), n
        obj = getattr(src, n)
        assert not (inspect.isfunction(obj) or inspect.isclass(obj)) or obj.__module__.startswith("xsdba_tpu_torch."), n
    if alias == "base":
        assert tbase.max_doy is xp.utils.calendar.MAX_DOY and tbase.max_doy == jbase.max_doy
        assert tbase.uniform_calendars == jbase.uniform_calendars


def test_units_registry_facade():
    from xsdba_tpu import units as ju
    from xsdba_tpu_torch import units as tu
    from xsdba_tpu_torch.utils import units as tuu

    assert tu.units.Quantity is tuu.Quantity and tu.units.Unit is tuu.Unit
    for s in ("1 mm/d", "0.5 K", "3 kg m-2 s-1"):
        q = tu.units(s)
        assert isinstance(q, tuu.Quantity)
        assert (q.magnitude, tuu.units2str(q.units)) == (ju.units(s).magnitude, ju.units2str(ju.units(s).units)), s
        assert tu.units.parse_expression(s).magnitude == q.magnitude
    assert tuu.units2str(tu.units.parse_units("mm/d")) == ju.units2str(ju.units.parse_units("mm/d"))


# ---------------------------------------------------------------- nbutils


def _nb_data(dtype):
    """[4 sites, 2 members, 50 days] with scattered NaNs and one all-NaN
    site; ranks a site with a NaN."""
    rng = np.random.default_rng(11)
    x = rng.normal(10, 3, (4, 2, 50)).astype(dtype)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[1] = np.nan
    rnk = rng.random(4).astype(dtype)
    rnk[2] = np.nan
    return x, rnk


def _nb_da(mod, x, dims=("site", "member", "time")):
    t = mod.date_range("2000-01-01", periods=x.shape[-1], freq="D", calendar="noleap")
    return mod.DataArray(x, dims, {"time": t, "site": np.arange(4)}, {"units": "K"}, "tas")


Q = [0.0, 0.1, 0.25, 0.5, 0.9, 0.999, 1.0]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("form", ["time", "member+time", "bare axis 1", "bare axis 0"])
def test_nbutils_quantile_equals_reference(form, dtype):
    """Every form reduces the same [4, 100] rows (the members flattened into
    time, or the sites along axis 0 of the transpose), so the reference
    compiles its eager operations for one shape a dtype."""
    x3, _ = _nb_data(dtype)
    x = x3.reshape(4, 100)
    if form.startswith("bare"):
        axis = int(form[-1])
        x = np.ascontiguousarray(x.T) if axis == 0 else x
        got, want = tnb.quantile(x, Q, axis), jnb.quantile(x, Q, axis)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.from_numpy(x).dtype
    else:
        if form == "time":
            dim, da = "time", (lambda m: _nb_da(m, x, ("site", "time")))
        else:
            dim, da = ("member", "time"), (lambda m: _nb_da(m, x3))
        got, want = tnb.quantile(da(xp), Q, dim), jnb.quantile(da(xt), Q, dim)
        assert got.dims == want.dims == ("site", "quantiles") and got.name == want.name and got.attrs == want.attrs
        assert sorted(got.coords) == sorted(want.coords)
        np.testing.assert_array_equal(got.coords["quantiles"], want.coords["quantiles"])
    assert _np(got).dtype == _np(want).dtype
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("form", ["DataArray", "DataArray ranks", "bare"])
def test_nbutils_vecquantiles_equals_reference(form, dtype):
    x3, rnk = _nb_data(dtype)
    x = x3.reshape(4, 100)
    if form == "bare":
        got, want = tnb.vecquantiles(x, rnk, 1), jnb.vecquantiles(x, rnk, 1)
    else:
        wrap = (lambda m: m.DataArray(rnk, ("site",), {}, {}, None)) if form == "DataArray ranks" else (lambda m: rnk)
        da = lambda m: _nb_da(m, x, ("site", "time"))  # noqa: E731
        got, want = tnb.vecquantiles(da(xp), wrap(xp), "time"), jnb.vecquantiles(da(xt), wrap(xt), "time")
        assert got.dims == want.dims == ("site",)
    assert _np(got).dtype == _np(want).dtype
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_remove_nans_equals_reference(as_tensor):
    x = np.random.default_rng(2).normal(size=(3, 40))
    x[0, 3] = x[2, 3] = x[1, 17] = x[2, 39] = np.nan
    got = tnb.remove_NaNs(torch.from_numpy(x) if as_tensor else x)
    assert isinstance(got, torch.Tensor) == as_tensor
    np.testing.assert_array_equal(_np(got), jnb.remove_NaNs(x))
    assert _np(got).shape == (3, 37)


@pytest.mark.parametrize("fn", ["quantile", "vecquantiles"])
def test_nbutils_bare_array_needs_an_integer_axis(fn):
    """The same ``TypeError`` and message as the JAX package's."""
    x = np.ones((2, 5))
    arg = [0.5] if fn == "quantile" else np.full(2, 0.5)
    with pytest.raises(TypeError) as want:
        getattr(jnb, fn)(x, arg, "time")
    with pytest.raises(TypeError) as got:
        getattr(tnb, fn)(x, arg, "time")
    assert str(got.value) == str(want.value)


def test_nbutils_numpy_goes_to_the_device_option():
    """Numpy data goes to the ``device`` option's device: asking for CUDA
    where there is none raises (no quiet fall-back); a tensor stays put."""
    x, rnk = _nb_data(np.float64)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; tests/test_torch_cuda.py runs nbutils there")
    with xp.set_options(device="cuda"):
        with pytest.raises(RuntimeError, match="set_options"):
            tnb.quantile(x, Q, 2)
        with pytest.raises(RuntimeError, match="set_options"):
            tnb.vecquantiles(_nb_da(xp, x[:, 0], ("site", "time")), rnk, "time")
        assert tnb.quantile(torch.from_numpy(x), Q, 2).device.type == "cpu"


# ---------------------------------------------------------------- base


def _base_da(mod):
    t = mod.date_range("2000-01-01", periods=730, freq="D", calendar="noleap")
    data = np.random.default_rng(0).normal(10, 2, (3, 730))
    return mod.DataArray(data, ("site", "time"), {"time": t}, {"units": "K"}, "tas")


@pytest.mark.parametrize("case", ["month mean", "dayofyear+31 std"])
def test_map_groups_equals_reference(case):
    got, want = [], []
    for mod, base, out in ((xp, tbase, got), (xt, jbase, want)):
        if case == "month mean":
            @base.map_groups(group_mean=["<PROP>"])
            def reduce(block, *, dim):
                return block.mean(dim)

            group = mod.Grouper("time.month")
        else:
            @base.map_groups(group_std=["<PROP>"])
            def reduce(block, *, dim):
                return block.std(dim)

            group = mod.Grouper("time.dayofyear", window=31)
        out.append(reduce(_base_da(mod), group=group))
    (g,), (w,) = got, want
    assert g.dims == w.dims and g.shape == w.shape == ((3, 12) if case == "month mean" else (3, 365))
    assert isinstance(g.data, torch.Tensor) and g.data.device.type == "cpu"
    np.testing.assert_array_equal(np.asarray(g.coords[g.dims[-1]]), np.asarray(w.coords[w.dims[-1]]))
    np.testing.assert_allclose(_np(g), _np(w), rtol=1e-12, atol=0)


def test_map_blocks_and_dask_stubs():
    """As ``tests/test_reference_api.py`` checks the JAX package's."""
    da = _base_da(xp)

    @tbase.map_blocks(reduces=["time"], out=["<PROP>"])
    def ident(ds, **kw):
        return ds

    assert ident(da) is da and ident.__mapped__ and ident.__reduces__ == ["time"] and ident.__out_vars__ == {"out": ["<PROP>"]}
    empty = tbase.duck_empty(("a", "b"), {"a": 2, "b": 3}, dtype="float32", chunks={"a": 1})
    assert isinstance(empty, xp.DataArray) and empty.shape == (2, 3) and empty.dims == ("a", "b") and empty.dtype == np.float32
    assert tbase.uses_dask(da) is False
    assert tbase.ensure_chunk_size(da, time=100) is da
    assert "noleap" in tbase.uniform_calendars


# ---------------------------------------------------------------- testing


def _attrs_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _attrs_equal(g, w)
        return
    if hasattr(want, "dims"):
        assert got.dims == want.dims and got.attrs == want.attrs and got.name == want.name
        assert sorted(got.coords) == sorted(want.coords)
        for d, c in want.coords.items():
            if d == "time":
                g = got.coords[d]
                assert (g.calendar, g.freq) == (c.calendar, c.freq)
                for f in ("year", "month", "day"):
                    np.testing.assert_array_equal(getattr(g, f), getattr(c, f))
            else:
                np.testing.assert_array_equal(np.asarray(got.coords[d]), np.asarray(c))
    np.testing.assert_array_equal(_np(got), _np(want))


FACTORIES = {
    "timeseries tas": lambda m: m.timeseries(np.arange(400.0)),
    "timeseries pr, 360_day": lambda m: m.timeseries(np.arange(400.0), name="pr", start="1990-03-01", calendar="360_day"),
    "timeseries other name, units": lambda m: m.timeseries(np.arange(10.0), name="hurs", units="%"),
    "timelonlatseries 1-D": lambda m: m.timelonlatseries(np.arange(30.0)),
    "timelonlatseries 3-D pr": lambda m: m.timelonlatseries(np.arange(60.0).reshape(10, 3, 2), name="pr", start="2001-02-27"),
    "cannon_2015_rvs random": lambda m: m.cannon_2015_rvs(500, seed=3),
    "cannon_2015_rvs quantiles": lambda m: m.cannon_2015_rvs(200, random=False),
    "nancov": lambda m: m.nancov(np.where(np.eye(3, 40, 5) > 0, np.nan, np.random.default_rng(4).normal(size=(3, 40)))),
    "synth_rainfall": lambda m: m.synth_rainfall(2.0, 3.0, wet_freq=0.4, size=(5, 100), seed=9),
    "cannon_2015_dist": lambda m: [d.ppf(np.linspace(0.01, 0.99, 9)) for d in m.cannon_2015_dist()],
}


@pytest.mark.parametrize("case", sorted(FACTORIES))
def test_testing_factories_equal_reference(case):
    _attrs_equal(FACTORIES[case](ttesting), FACTORIES[case](jtesting))
    assert set(ttesting.__all__) == set(jtesting.__all__)


def test_timelonlatseries_rejects_unsupported_names():
    with pytest.raises(ValueError) as want:
        jtesting.timelonlatseries(np.arange(3.0), name="hurs")
    with pytest.raises(ValueError) as got:
        ttesting.timelonlatseries(np.arange(3.0), name="hurs")
    assert str(got.value) == str(want.value) == "Name `hurs` not supported."


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("shape,pads", [((150, 365), (8, 128)), ((2, 365, 150), (128, 8)), ((3, 7, 5), (8, 128)), ((16, 128), (8, 128))])
def test_aligned_swap_last2_equals_reference(shape, pads):
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    got = torch_swap(x, *pads)
    assert got.is_contiguous() and tuple(got.shape) == shape[:-2] + (shape[-1], shape[-2])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_swap(x, *pads)))


# ---------------------------------------------------------------- profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.arange(1000.0)
    with profiling.trace(str(tmp_path / "t")):
        torch.sort(x.flip(0))
    (f,) = (tmp_path / "t").iterdir()
    events = json.loads(f.read_text())["traceEvents"]
    assert any("sort" in e.get("name", "") for e in events)
    with pytest.raises(ValueError, match="host_tracer_level"):
        with profiling.trace(str(tmp_path / "u"), host_tracer_level=4):
            pass
    if not torch.cuda.is_available():  # level 0 records the card alone
        with pytest.raises(ValueError, match="cuda"):
            with profiling.trace(str(tmp_path / "u"), host_tracer_level=0):
                pass
    with pytest.raises(KeyError):  # the block's own error, and no file
        with profiling.trace(str(tmp_path / "u")):
            raise KeyError("x")
    assert not (tmp_path / "u").exists()


def test_timed_returns_the_best_time_and_the_last_output():
    calls = []

    def fn(a, *, b):
        calls.append(1)
        return {"out": xp.DataArray(torch.full((3,), float(len(calls))), ("x",)), "b": b}

    best, out = profiling.timed(fn, 1, b=2, reps=4, warmup=2)
    assert best > 0 and len(calls) == 6
    assert out["b"] == 2 and float(out["out"].data[0]) == 6.0
    assert profiling._first_tensor([1, {"a": (None, out["out"])}]) is out["out"].data


# ---------------------------------------------------------------- cli, native


def _jax_selftest_residual():
    """The JAX package's ``cli._selftest`` EQM (it prints 4 decimals)."""
    from scipy import stats

    t = xt.date_range("2000-01-01", periods=365 * 3, freq="D", calendar="noleap")
    u = np.random.default_rng(0).random(len(t))
    ref = xt.DataArray(stats.norm.ppf(u, 10, 1), ("time",), {"time": t}, {"units": "K"}, "tas")
    hist = xt.DataArray(stats.norm.ppf(u, 12, 2), ("time",), {"time": t}, {"units": "K"}, "tas")
    scen = xt.EmpiricalQuantileMapping.train(ref, hist, group="time.month", nquantiles=20).adjust(hist, interp="linear")
    return float(np.abs(np.asarray(scen.data) - np.asarray(ref.data)).mean())


def test_cli_version_and_selftest(capsys):
    assert cli.main(["--version"]) == 0
    assert capsys.readouterr().out.strip() == xp.__version__
    assert cli.main(["selftest"]) == 0
    out = capsys.readouterr().out
    assert "selftest on cpu" in out and "OK" in out and "native EMD solver: available" in out
    bias, device = cli._selftest_run()
    assert device.type == "cpu"
    np.testing.assert_allclose(bias, _jax_selftest_residual(), rtol=0, atol=1e-6)


def test_cli_bench_and_imports_in_a_fresh_process():
    """In a fresh process: ``from xsdba_tpu_torch import base`` imports the
    shell's ``base`` (the top level's lazy names skip submodules, C27);
    ``bench`` reports the missing benchmark and returns 1, loading no JAX
    module; ``python -m xsdba_tpu_torch.cli`` runs ``main``."""
    probe = """
import json, runpy, sys
from xsdba_tpu_torch import base, cli, nbutils, options, testing, units
names = [m.__name__ for m in (base, cli, nbutils, options, testing, units)]
rc = cli.main(["bench"])
jax = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "xsdba_tpu"))
sys.argv = ["xsdba_tpu_torch.cli", "--version"]
try:
    runpy.run_module("xsdba_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    code = e.code
print(json.dumps([names, rc, jax, code]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    names, rc, jax, code = json.loads(lines[-1])
    assert names == [f"xsdba_tpu_torch.{m}" for m in ("base", "cli", "nbutils", "options", "testing", "units")]
    assert (rc, jax) == (1, []) and "ROADMAP A3" in res.stderr
    assert (code, lines[-2]) == (0, xp.__version__)


def test_have_native_reports_the_solver(monkeypatch, tmp_path):
    """C26: True where ``g++`` builds the solver; False, without a fall-back,
    where the build fails: ``emd`` then raises."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    assert native.have_native() is True
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "missing.so")

    def fail(lib):
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "_build", fail)
    assert native.have_native() is False
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.emd(np.ones(2), np.ones(2), np.eye(2))
