"""The port's spans and counters (``xsdba_tpu_torch/utils/profiling.py``),
on the CPU.

While a ``torch.profiler`` session records, the public calls and each layer
boundary open ``xsdba.*`` ranges in the trace, nested as the code nests
them, and the port keeps the same spans in memory with the counter deltas
of each public call; with no session, nothing is recorded and the profiler
is never entered.  The counters count every site on every device: the
uploads of the monthly QDM adjust and the host reads of the windowed EQM
train are what their shapes and chunks say.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import xsdba_tpu_torch as xp
from xsdba_tpu_torch.ops import quantile
from xsdba_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
NQ = 20
SITES = 3
YEARS = 4


@pytest.fixture(autouse=True)
def _cpu_merge_engine():
    """The CPU, the merge engine for windowed groups, an empty store."""
    profiling.reset_spans()
    with xp.set_options(device="cpu", selection_backend=False):
        yield
    profiling.reset_spans()


def _data(seed=0, sites=SITES):
    t = xp.date_range("2001-01-01", periods=365 * YEARS, freq="D", calendar="noleap")
    rng = np.random.default_rng(seed)

    def da(loc):
        x = rng.normal(loc, 4.0, (sites, len(t))).astype(np.float32)
        return xp.DataArray(torch.as_tensor(x), ("site", "time"), {"time": t}, {"units": "K"}, "tas")

    return da(280.0), da(282.0), da(283.0)


CASES = {
    "monthly QDM": (xp.QuantileDeltaMapping, {"group": "time.month"}),
    "doy+31 EQM": (xp.EmpiricalQuantileMapping, {"group": xp.Grouper("time.dayofyear", window=31)}),
}


def _pair(case, ref, hist, sim):
    cls, kw = CASES[case]
    obj = cls.train(ref, hist, nquantiles=NQ, kind="+", **kw)
    return obj, obj.adjust(sim, interp="linear")


def _traced(fn, tmp_path):
    """Run ``fn`` under the profiler; the trace's ``xsdba.*`` ranges."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith("xsdba.")]


def _nesting(events):
    """(name, enclosing range's name) of each range, in the order they open."""
    out, stack = [], []
    for e in sorted(events, key=lambda e: (float(e["ts"]), -float(e["dur"]))):
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        while stack and stack[-1][1] < t1:
            stack.pop()
        name = e["name"][len("xsdba."):]
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, t1, t0))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest_in_the_trace_as_in_memory(case, tmp_path):
    ref, hist, sim = _data()
    _pair(case, ref, hist, sim)                          # the grouping lowered and cached
    profiling.reset_spans()
    events = _traced(lambda: _pair(case, ref, hist, sim), tmp_path)
    calls = profiling.calls()
    assert [c["name"] for c in calls] == ["train", "adjust"]
    assert calls[0]["call"] < calls[1]["call"]
    records = [(s["name"], s["parent"]) for c in calls for s in c["spans"]]
    assert all(s["call"] == c["call"] and s["ns"] > 0 for c in calls for s in c["spans"])
    assert _nesting(events) == records
    train, adjust = ({(s["name"], s["parent"]) for s in c["spans"]} for c in calls)
    assert {("quantiles", "train"), ("correction", "train"), ("api.checks", "train")} <= train
    if case == "doy+31 EQM":
        assert {("quantiles.chunk", "quantiles"), ("merge", "quantiles.chunk"),
                ("quantiles.extract_static", "quantiles.chunk"), ("lower.extract", "quantiles.extract_static")} <= train
    else:
        assert ("rank", "adjust") in adjust
    assert {("lower.brackets", "adjust"), ("lookup", "adjust"), ("correction", "adjust"), ("api.output", "adjust")} <= adjust


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    entered = []

    class StandIn:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", StandIn)
    ref, hist, sim = _data()
    before = profiling.counters()
    _pair("doy+31 EQM", ref, hist, sim)
    assert profiling.span("train") is profiling.span("lookup")      # one shared no-op
    assert entered == [] and profiling.calls() == []
    assert profiling.counters()["upload.arrays"] > before.get("upload.arrays", 0)   # counters stay on
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("probe"):
            pass
    assert entered == ["xsdba.probe"] and [c["name"] for c in profiling.calls()] == ["probe"]


def test_snapshot_holds_the_benchmarks_launch_counters(monkeypatch):
    import importlib

    named = {(m, a, k): n for n, m, a, k in profiling.MODULE_COUNTERS}
    listed = json.loads((ROOT / "portbench" / "counters.json").read_text())["counters"]
    for i, c in enumerate(listed):
        mod = importlib.import_module(c["module"])
        name = named[(c["module"], c["attr"], c.get("key"))]
        if "key" in c:
            monkeypatch.setitem(getattr(mod, c["attr"]), c["key"], 100 + i)
        else:
            monkeypatch.setattr(mod, c["attr"], 100 + i)
        value = getattr(mod, c["attr"])
        assert profiling.counters()[name] == (value[c["key"]] if "key" in c else value) == 100 + i
    assert profiling.counters("launch.")["fma"] == profiling.counters()["launch.fma"]
    profiling.count("sync.probe", 3)
    profiling.reset_counters()
    assert not any(profiling.counters().values())


def test_uploads_of_the_monthly_qdm_adjust():
    ref, hist, sim = _data()
    obj, _ = _pair("monthly QDM", ref, hist, sim)
    before = profiling.counters()
    obj.adjust(sim, interp="linear")
    got = profiling.counters()
    gi_rank = xp.Grouper("time.month").indexes(sim.time)
    b = obj.group.indexes(sim.time).bracket_partitions("linear")
    T = sim.sizes["time"]
    want = {
        "quantiles": NQ * 4,                              # float32, sim's dtype
        "rank indexes": gi_rank.gather_idx.nbytes + gi_rank.group_idx.nbytes + gi_rank.scatter_slot.nbytes,
        "partitions": 8 * sum(b[k].size for k in ("part0", "g0", "slot0", "part1", "g1", "slot1")),
        "weights": 8 * T,
        "kernel steps": 3 * 4 * T,                        # g0, g1 int32 and w float32
    }
    assert got["upload.bytes"] - before.get("upload.bytes", 0) == sum(want.values())
    assert got["upload.arrays"] - before.get("upload.arrays", 0) == 1 + 3 + 6 + 1 + 3


def test_syncs_of_the_windowed_eqm_train(monkeypatch):
    monkeypatch.setattr(quantile, "_windowed_max_chunk", lambda plan: 2)
    ref, hist, _ = _data(sites=5)
    cls, kw = CASES["doy+31 EQM"]
    cls.train(ref, hist, nquantiles=NQ, kind="+", **kw)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        cls.train(ref, hist, nquantiles=NQ, kind="+", **kw)
    (call,) = profiling.calls()
    chunks = sum(s["name"] == "quantiles.chunk" for s in call["spans"])
    assert chunks == 5                                    # ref and hist stacked: 10 sites, 2 a chunk
    assert sum(v for k, v in call["counters"].items() if k.startswith("sync.")) == 1 + chunks
    assert call["counters"]["sync.static_safe"] == 1 and call["counters"]["sync.quantiles_host"] == chunks


def test_the_store_keeps_the_last_calls():
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(profiling.CALLS_KEPT + 3):
            with profiling.span("probe"):
                with profiling.span("probe"):             # a re-entry adds nothing
                    pass
    calls = profiling.calls()
    assert len(calls) == profiling.CALLS_KEPT and all(len(c["spans"]) == 1 for c in calls)
    assert calls[-1]["call"] - calls[0]["call"] == profiling.CALLS_KEPT - 1
    profiling.reset_spans()
    assert profiling.calls() == []
