"""The readers of the port's host work (``metrics/host.*.py``) on a store
of the port's public calls filled by hand: the first ``blocks`` train +
adjust pairs of the traced run, nothing where pairs are missing or nothing
was traced, and the units."""

from types import SimpleNamespace

import pytest

from portbench import spec
from xsdba_tpu_torch.utils import profiling

NAMES = ("host.lower_ms", "host.syncs_per_block", "host.upload_mib_per_block")


def _call(i, name, lower_ns=(), syncs=0, upload=0):
    spans = [{"name": name, "parent": None, "ns": 10**9, "call": i}]
    for k, ns in enumerate(lower_ns):
        # an outermost lowering and one inside another, which is not counted twice
        spans.append({"name": "lower.brackets" if k % 2 == 0 else "lower.extract", "parent": name, "ns": ns, "call": i})
        spans.append({"name": "lower.indexes", "parent": spans[-1]["name"], "ns": ns // 2, "call": i})
    counters = {"sync.static_safe": syncs, "sync.quantiles_host": 2 * syncs, "upload.bytes": upload, "upload.arrays": 7}
    return {"call": i, "name": name, "ns": 10**9, "spans": spans, "counters": {k: v for k, v in counters.items() if v}}


def _store(pairs, lead=()):
    calls, i = list(lead), len(lead)
    for p, (lower, syncs, upload) in enumerate(pairs):
        calls.append(_call(i, "train", lower_ns=lower, syncs=syncs, upload=upload))
        calls.append(_call(i + 1, "adjust", lower_ns=(2_000_000,), upload=2**20))
        i += 2
    return calls


def _read(monkeypatch, calls, blocks=2, trace=True):
    monkeypatch.setattr(profiling, "calls", lambda: calls)
    ctx = SimpleNamespace(trace={"blocks": blocks} if trace else None)
    return {n: spec.reader(n).read(ctx) for n in NAMES}


def test_first_pairs_and_units(monkeypatch):
    # a stray adjust and a lone quantiles call before the blocks; a third pair after them
    lead = [_call(0, "adjust", upload=5 * 2**20, syncs=9), _call(1, "quantiles", syncs=9)]
    calls = _store([((1_000_000, 3_000_000), 1, 3 * 2**20), ((5_000_000,), 2, 2**20), ((90_000_000,), 50, 50 * 2**20)], lead)
    got = _read(monkeypatch, calls)
    # block 1: 1 + 3 + 2 ms, block 2: 5 + 2 ms
    assert got["host.lower_ms"] == pytest.approx(6.5)
    assert got["host.syncs_per_block"] == pytest.approx((3 * 1 + 3 * 2) / 2)
    assert got["host.upload_mib_per_block"] == pytest.approx((3 + 1 + 1 + 1) / 2)


def test_nothing_without_the_pairs(monkeypatch):
    calls = _store([((1_000_000,), 1, 2**20)])
    assert set(_read(monkeypatch, calls, blocks=2).values()) == {None}          # one pair of two
    train_only = [c for c in _store([((1,), 1, 1)] * 2) if c["name"] == "train"]
    assert set(_read(monkeypatch, train_only, blocks=2).values()) == {None}
    assert set(_read(monkeypatch, _store([((1,), 1, 1)] * 2), trace=False).values()) == {None}   # nothing traced (the CPU)


def test_nothing_from_a_port_that_keeps_no_calls(monkeypatch):
    monkeypatch.delattr(profiling, "calls")
    ctx = SimpleNamespace(trace={"blocks": 1})
    assert {spec.reader(n).read(ctx) for n in NAMES} == {None}


def test_entries_name_the_public_api_layer():
    bench = spec.load_benchmark()
    cells = [c["name"] for c in bench["workloads"]]
    entries = {m["name"]: m for m in bench["per_layer"] if m["name"] in NAMES}
    assert set(entries) == set(NAMES)
    for m in entries.values():
        assert m["layer"] == "public API" and m["moves"] == "gpyr_per_s" and m["better"] == "lower" and m["workloads"] == cells
