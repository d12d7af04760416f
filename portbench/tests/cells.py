"""The benchmark's cells, and checkouts of it whose mixes are cut to tiny
sizes for the CPU (or small ones for a quick look on the card): a copy of
``BENCHMARK.json`` and ``portbench/`` (without its tests) under a
directory, which a run takes as its ``root``."""

import json
import shutil
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]

#: tiny sizes of each mix, small enough for the CPU
TINY = {
    "full150": {"sites_per_block": 8, "train_years": 4, "sim_years": 4, "pool_blocks": 2, "sample_sites": 4},
    "cal30_sim150": {"sites_per_block": 8, "train_years": 3, "sim_years": 6, "pool_blocks": 2, "sample_sites": 4},
}

CELLS = ["qdm_month_tas.full150", "eqm_doy31_tas.full150", "eqm_doy31_tas.cal30_sim150"]


def checkout(base: Path, sizes: dict) -> Path:
    """A copy of the benchmark under ``base`` with each mix's sizes
    replaced by ``sizes[mix]`` (a dict of the mix's keys, or, for every mix,
    one dict under ``"*"``)."""
    root = Path(base)
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(PKG.parent / "BENCHMARK.json", root)
    shutil.copytree(PKG, root / PKG.name, ignore=shutil.ignore_patterns("tests", "__pycache__"), dirs_exist_ok=True)
    for path in (root / PKG.name / "mixes").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(sizes.get(path.stem, sizes.get("*", {})))
        path.write_text(json.dumps(mix))
    return root
