"""MBCn of the port through the benchmark's cell ``mbcn_tas_pr_huss.cal30_fut30``,
on the CPU at a tiny size (8 sites x 3 variables x 4 years, 20 rotations, 20
quantiles, the cell's own generator), held to the plain NumPy reference
(``portbench/reference/mbcn.py``) under the cell's four numbers.

The cell's limits hold what MBCn promises, since float32 trajectories part
from float64 ones wherever an ulp moves a rank across a ``nearest`` node:
each variable's marginal, the Spearman correlations between variables and
the trained factors.  Planted faults under the public calls (the reordering
left out, 19 rotations, pr adjusted additively) and the reference computed
in bfloat16 in the program's place each come out not correct.  In float64
the port and the reference agree to rounding.  ``MBCn.adjust`` labels a
``multivar`` dimension without a coordinate 0..V-1, as ``train`` does (a
program that cannot fails the cell at set-up), and one public pair records
the npdft and reordering spans and 40 rotations.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import xsdba_tpu_torch as xp
from portbench import check, run, spec
from portbench.reference.qm import bfloat16
from portbench.tests.cells import TINY, checkout
from xsdba_tpu_torch.models import mbcn as tmbcn
from xsdba_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = "mbcn_tas_pr_huss.cal30_fut30"
SIZES = dict(TINY, cal30_fut30={"sites_per_block": 8, "train_years": 4, "sim_years": 4, "pool_blocks": 2, "sample_sites": 6})
SEEDS = [3, 2**31 + 99]


@pytest.fixture(autouse=True)
def _on_cpu():
    profiling.reset_spans()
    with xp.set_options(device="cpu"):
        yield
    profiling.reset_spans()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("mbcn"), SIZES)


def _run(root, seed=SEEDS[0]):
    return run.run(CELL, seed, 0.2, False, "cpu", root=root, log=lambda s: None)


def _cell_data(root, seed=SEEDS[0]):
    """The first pool entry of the tiny cell as the harness wraps it."""
    c = run.Cell(CELL, root)
    c.setup(seed, "cpu")
    das = c.das[0]
    c.free()
    return c, das


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(root, seed):
    r = _run(root, seed)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["compared"]) == {"scen_sorted_sd", "scen_spearman", "afq_first_max_abs", "afq_all_max_abs"}
    assert all(v["value"] <= v["limit"] for v in r["compared"].values())


def _skip_reordering(ref, sim):
    return sim


def _nineteen(rot_matrices, n_features, n_iter, like):
    return _ROTATIONS(rot_matrices, n_features, n_iter, like)[:19]


def _pr_additive(refa, hista, sima, rows_ref, rows_sim, base_kws, adj_kws, units=""):
    return _UNIVARIATE(refa, hista, sima, rows_ref, rows_sim, {k: v for k, v in base_kws.items() if k != "kind"}, adj_kws, units)


_ROTATIONS, _UNIVARIATE = tmbcn._rotations, tmbcn._per_block_univariate
FAULTS = {
    "reordering_skipped": ("_reordering_core", _skip_reordering, "scen_spearman"),
    "nineteen_rotations": ("_rotations", _nineteen, "afq_all_max_abs"),
    "pr_additive": ("_per_block_univariate", _pr_additive, "scen_sorted_sd"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(root, fault, monkeypatch):
    name, planted, number = FAULTS[fault]
    monkeypatch.setattr(tmbcn, name, planted)
    r = _run(root)
    assert not r["correct"] and r["failed"] == r["attempted"] > 0
    assert r["compared"][number]["value"] > r["compared"][number]["limit"]


@pytest.mark.parametrize("seed", SEEDS)
def test_bfloat16_reference_is_not_correct(root, seed):
    """The control: the reference rounded to bfloat16 at every stage, put
    in the program's place, fails the cell's numbers."""
    c = run.Cell(CELL, root)
    c.setup(seed, "cpu")
    got, inputs = c.samples_to_host()
    c.free()
    want = c.expected(inputs)
    r = check.compare(sorted(c.expected(inputs, rnd=bfloat16).items()), want, c.limits)
    assert not r["correct"] and r["failed"] == r["attempted"] == len(inputs)
    assert r["compared"]["afq_first_max_abs"]["value"] > r["compared"]["afq_first_max_abs"]["limit"]


def test_float64_port_agrees_with_the_reference(root):
    """The port in float64 and the float64 reference compute the same
    factors and the same scen, to rounding."""
    c, das = _cell_data(root)
    f64 = {k: xp.DataArray(v.data.double(), v.dims, dict(v.coords), dict(v.attrs), v.name) for k, v in das.items()}
    obj = xp.MBCn.train(f64["ref"], f64["hist"], **c.config["train"])
    scen = obj.adjust(f64["sim"], f64["ref"], f64["hist"], **c.config["adjust"])
    want = spec.reference(c.config, root).train_adjust(c.config, {k: v.data.numpy() for k, v in f64.items()}, c.days)
    np.testing.assert_allclose(obj.ds["af_q"].data.numpy(), want["af_q"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(scen.data.numpy(), want["scen"], rtol=0, atol=1e-9 * np.abs(want["scen"]).max())


@pytest.mark.parametrize("dims", [("site", "multivar", "time"), ("multivar", "site", "time")])
def test_adjust_labels_a_dimension_without_coordinate(root, dims):
    c, das = _cell_data(root)
    bare = {k: v.transpose(*dims) for k, v in das.items()}
    labelled = {k: xp.DataArray(v.data, v.dims, {**v.coords, "multivar": np.arange(3)}, dict(v.attrs), v.name) for k, v in bare.items()}
    assert "multivar" not in bare["sim"].coords
    out = []
    for d in (bare, labelled):
        obj = xp.MBCn.train(d["ref"], d["hist"], **c.config["train"])
        out.append(obj.adjust(d["sim"], d["ref"], d["hist"], **c.config["adjust"]))
    assert out[0].dims == dims
    assert torch.equal(out[0].data, out[1].data)


def test_a_program_that_cannot_adjust_fails_at_setup(root, monkeypatch):
    """A program whose ``MBCn.adjust`` needs a ``multivar`` coordinate,
    which the harness's arrays lack, raises at set-up, before any block."""
    def needs_coordinate(self, sim, *args, **kwargs):
        return sim.coords["multivar"]

    monkeypatch.setattr(tmbcn.MBCn, "_adjust", needs_coordinate)
    c = run.Cell(CELL, root)
    try:
        with pytest.raises(KeyError, match="multivar"):
            c.setup(SEEDS[0], "cpu")
    finally:
        c.options.__exit__(None, None, None)


def test_spans_and_rotations_of_a_public_pair(root):
    c, das = _cell_data(root)
    obj = xp.MBCn.train(das["ref"], das["hist"], **c.config["train"])
    obj.adjust(das["sim"], das["ref"], das["hist"], **c.config["adjust"])        # built and cached
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        obj = xp.MBCn.train(das["ref"], das["hist"], **c.config["train"])
        obj.adjust(das["sim"], das["ref"], das["hist"], **c.config["adjust"])
    train, adjust = profiling.calls()
    assert (train["name"], adjust["name"]) == ("train", "adjust")
    assert ("npdft.train", "train") in {(s["name"], s["parent"]) for s in train["spans"]}
    assert {("mbcn.univariate", "adjust"), ("npdft.adjust", "adjust"), ("reorder", "adjust")} <= {(s["name"], s["parent"]) for s in adjust["spans"]}
    assert train["counters"]["npdft.rotations"] + adjust["counters"]["npdft.rotations"] == 40
    assert train["counters"]["upload.arrays"] >= 3 and adjust["counters"]["upload.arrays"] >= 7   # rotations, nodes, indexes


def test_reference_is_plain_numpy():
    """Importing the reference loads nothing of PyTorch, JAX, the JAX
    package or the port."""
    code = (
        "import sys\n"
        "import portbench.reference.mbcn\n"
        "print(sorted({m.partition('.')[0] for m in sys.modules} & {'torch', 'jax', 'jaxlib', 'xsdba_tpu', 'xsdba_tpu_torch'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["[]"]


def test_generator_gives_three_dependent_positive_variables(root):
    c = run.Cell(CELL, root)
    c.setup(SEEDS[1], "cpu")
    block = c.pool[0]
    c.free()
    assert block["ref"].shape == (8, 3, 4 * 365) and block["sim"].shape == (8, 3, 4 * 365)
    tas, pr, huss = (block["ref"][:, v] for v in range(3))
    assert 220 < float(tas.min()) and float(tas.max()) < 340
    assert float(pr.min()) > 0 and float((pr < 0.01).float().mean()) > 0.3                 # dry days
    assert 0 < float(huss.min()) and float(huss.max()) < 0.05
    assert float(block["sim"][:, 0].mean()) > float(block["hist"][:, 0].mean()) + 0.05   # warmed


RNG = np.random.default_rng(0)
X = RNG.normal(size=(4, 3, 50))


@pytest.mark.parametrize("measure,got,want,expected", [
    ("sorted_sd", X[..., ::-1], X, 0.0),                          # any order of the days
    ("sorted_sd", X + 0.5 * X.std(axis=-1, keepdims=True), X, 0.5),
    ("sorted_sd", X[:, :2], X, np.inf),
    ("spearman", X * 3 + 1, X, 0.0),                              # ranks alone
    ("spearman", np.where(np.arange(50) == 7, np.nan, X), X, np.inf),
    ("spearman", X[:2], X, np.inf),
    ("first_iteration_max_abs", X.reshape(4, 1, 3, 5, 10) + np.arange(3)[:, None, None] * 1.0, X.reshape(4, 1, 3, 5, 10), 0.0),
    ("first_iteration_max_abs", X.reshape(4, 1, 3, 5, 10)[:, :, :2], X.reshape(4, 1, 3, 5, 10), np.inf),
])
def test_measures(measure, got, want, expected):
    gap = spec.module("measures", measure).gap(got, want)
    assert gap == pytest.approx(expected, abs=1e-12) if np.isfinite(expected) else gap == expected
