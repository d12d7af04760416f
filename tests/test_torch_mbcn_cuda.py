"""MBCn of the port on an NVIDIA GPU: one public train + adjust pair of the
benchmark cell ``mbcn_tas_pr_huss.cal30_fut30``'s configuration at a small
size (64 sites x 3 variables x 4 years, the cell's generator), every host
wait of it counted, and its result held to the plain NumPy reference
(``portbench/reference/mbcn.py``) under the cell's limits; the rotations
in full float32 whatever cuBLAS's TF32 setting.

Every test here needs a card and skips without one.  The file imports no
JAX; run it on the card with ``tests/test_torch_cuda.py``'s command.
"""

import warnings

import numpy as np
import pytest
import torch

import xsdba_tpu_torch as xp
from portbench import check, run, spec
from portbench.tests.cells import checkout
from xsdba_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

CELL = "mbcn_tas_pr_huss.cal30_fut30"
SIZES = {"cal30_fut30": {"sites_per_block": 64, "train_years": 4, "sim_years": 4, "pool_blocks": 1, "sample_sites": 32}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("mbcn_cuda"), SIZES)


def _pair(c, das):
    obj = xp.MBCn.train(das["ref"], das["hist"], **c.config["train"])
    return obj, obj.adjust(das["sim"], das["ref"], das["hist"], **c.config["adjust"])


def test_public_pair_counts_every_wait_and_holds_the_reference(cuda, root):
    """Under ``set_sync_debug_mode("warn")`` the pair warns once per host
    read (``sync.*``) and once per upload, and at no other site; the sampled
    sites of its scen and af_q are within the cell's limits."""
    c = run.Cell(CELL, root)
    c.setup(2**31 + 7, cuda)
    das = c.das[0]
    _pair(c, das)                                           # built and cached
    torch.cuda.synchronize()
    before = profiling.counters()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            obj, scen = _pair(c, das)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    after = profiling.counters()
    moved = {n: v - before.get(n, 0) for n, v in after.items()}
    waits = sum(v for n, v in moved.items() if n.startswith("sync.")) + moved["upload.arrays"]
    assert sum("synchronizing CUDA operation" in str(w.message) for w in seen) == waits > 0
    assert moved["npdft.rotations"] == 40
    c.keep(0, obj, scen)
    got, inputs = c.samples_to_host()
    c.free()
    r = c.verify(got, inputs)
    assert r["correct"], r["compared"]


@pytest.mark.parametrize("tf32", [True, False])
def test_rotations_ignore_the_tf32_setting(cuda, root, tf32):
    """The trained factors are the same bits with cuBLAS's float32 matmuls
    left in TF32 as in full precision, and the setting is put back."""
    c = run.Cell(CELL, root)
    c.setup(11, cuda)
    das = c.das[0]
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    try:
        mm.allow_tf32 = False
        want = xp.MBCn.train(das["ref"], das["hist"], **c.config["train"]).ds["af_q"].data
        mm.allow_tf32 = tf32
        got = xp.MBCn.train(das["ref"], das["hist"], **c.config["train"]).ds["af_q"].data
        assert mm.allow_tf32 == tf32
    finally:
        mm.allow_tf32 = prev
    c.free()
    assert torch.equal(got, want)


def test_reference_at_a_run_size_on_the_host(cuda, root):
    """The reference takes a cell's sampled rows at its timed size (34
    sites x 3 x 30 years, one pool entry) and gives finite scen of their
    shape; the outputs compared are af_q and scen."""
    c = run.Cell(CELL, checkout(root.parent / "full_size", {"cal30_fut30": {"pool_blocks": 1}}))
    c.setup(5, cuda)
    _, inputs = c.samples_to_host()
    c.free()
    out = spec.reference(c.config, c.root).train_adjust(c.config, inputs[0], c.days)
    assert out["scen"].shape == inputs[0]["sim"].shape and np.isfinite(out["scen"]).all()
    assert check.outputs(c.limits) == ["af_q", "scen"]
