"""The harness finds what a later cell brings as files alone, with its
``BENCHMARK.json`` entries, and runs the new cell: a configuration with
its own data generator, plain reference and grouping, a mix on another
calendar with masked values, limits on another output under a new
measure, options of the port, and a new metric."""

import json

import xsdba_tpu_torch as xt
from portbench import run, spec

from .cells import TINY, checkout

GENERATOR = '''"""tas_ar1's data, every value of hist 1 K warmer."""
from .tas_ar1 import DIMS, make_block as _base


def make_block(g, assumed, sites, days, device, dtype):
    out = _base(g, assumed, sites, days, device, dtype)
    return dict(out, hist=out["hist"] + 1)
'''

REFERENCE = '''"""The qm reference under another name."""
from .qm import train_adjust  # noqa: F401
'''

MEASURE = '''import numpy as np


def gap(got, want):
    """The widest gap relative to the reference's largest magnitude."""
    return float(np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want)))
'''


def test_added_files_are_found(tmp_path):
    root = checkout(tmp_path / "checkout", TINY)
    pb = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())

    cfg = json.loads((pb / "configs" / "eqm_doy31_tas.json").read_text())
    cfg.update(name="eqm_time_tas", generator="tas_warm_hist", reference="qm_again",
               train={"group": "time", "nquantiles": 20, "kind": "+"}, options={"selection_backend": False})
    (pb / "configs/eqm_time_tas.json").write_text(json.dumps(cfg))
    (pb / "generators/tas_warm_hist.py").write_text(GENERATOR)
    (pb / "reference/qm_again.py").write_text(REFERENCE)
    (pb / "measures/max_rel.py").write_text(MEASURE)
    mix = {"why": "a tiny added mix", "calendar": "standard", "nan_sites": 0.25, "nan_values": 0.02, "sites_per_block": 8,
           "train_start": "1991-01-01", "train_years": 3, "sim_start": "1991-01-01", "sim_years": 5, "pool_blocks": 2,
           "sample_sites": 3}
    (pb / "mixes/tiny5.json").write_text(json.dumps(mix))
    numbers = {"scen_max_abs_K": {"output": "scen", "measure": "max_abs", "limit": 0.002},
               "hist_q_max_rel": {"output": "hist_q", "measure": "max_rel", "limit": 1e-6}}
    (pb / "limits/eqm_time_tas.tiny5.json").write_text(json.dumps({"numbers": numbers}))
    (pb / "metrics/blocks_run.py").write_text("def read(ctx):\n    return len(ctx.block_s)\n")
    bench["configs"].append({"name": "eqm_time_tas", "source": "a test", "file": "portbench/configs/eqm_time_tas.json",
                             "reduced": ["train"], "why": "a test"})
    bench["workloads"].append({"name": "eqm_time_tas.tiny5", "config": "eqm_time_tas", "traffic": "tiny5",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "blocks_run", "unit": "blocks", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["eqm_time_tas.tiny5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    got = spec.load_benchmark(root)
    cell = spec.cell(got, "eqm_time_tas.tiny5")
    assert spec.config(got, cell, root)["train"]["group"] == "time"
    assert spec.mix(cell, root)["calendar"] == "standard"
    assert "blocks_run" in [m["name"] for m in spec.metrics(got, cell, "end_to_end")]
    assert "blocks_run" not in [m["name"] for m in spec.metrics(got, spec.cell(got, "qdm_month_tas.full150"), "end_to_end")]

    before = xt.get_option("selection_backend")
    c = run.Cell("eqm_time_tas.tiny5", root)
    c.setup(3, "cpu")
    assert all(float(b["hist"].nan_to_num().sum()) != 0 for b in c.pool)
    assert c.days["train"].n == 3 * 365 + 1 and c.outputs == ["hist_q", "scen"]
    assert xt.get_option("selection_backend") is False      # the configuration's options, until free()
    c.free()
    assert xt.get_option("selection_backend") == before

    r = run.run("eqm_time_tas.tiny5", 4, 0.2, False, "cpu", root=root, log=lambda s: None)
    assert r["correct"] and r["metrics"]["blocks_run"]["value"] == r["attempted"] > 0
    assert set(r["compared"]) == set(numbers) and r["compared"]["hist_q_max_rel"]["value"] < 1e-6


def test_every_metric_has_a_reader():
    bench = spec.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read), m["name"]
    for m in bench["per_layer"]:
        layers = spec.layers()
        assert m["moves"] in [e["name"] for e in bench["end_to_end"]]
        assert m["layer"] in [v["layer"] for v in layers.values()] + ["public API", "device"], m
