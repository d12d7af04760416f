"""On the card: a traced run of each cell at a small size is correct, its
trace holds every kernel the port counted, and its layers have device
time.  Marked ``cuda``; skips without a card."""

import pytest
import torch

from portbench import run

from .cells import CELLS, checkout

SMALL = {"sites_per_block": 64, "train_years": 30, "sim_years": 30, "pool_blocks": 2, "sample_sites": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run.run(cell, 2**31 + 5, 0.5, True, "cuda", root=checkout(tmp_path, {"*": SMALL}), log=lambda s: None)
    assert r["correct"], r["compared"]
    m = r["metrics"]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert 0 < m["lookup_roofline"]["value"] <= 100 and 0 < m["quantile_roofline"]["value"] <= 100
    assert ("merge.device_ms" in m) == cell.startswith("eqm") and ("rank.device_ms" in m) == cell.startswith("qdm")
    assert len(r["breakdown"]["device_ops"]) > 0
