"""The comparison that decides ``correct``.

Every block of a run keeps the rows of sampled sites of the outputs that
the cell's numbers compare.  The sites are drawn from the seed: one from
each of ``sample_sites`` equal strata of the block, and its first and last
site, so that a fault confined to part of a block (a chunk of the
windowed path, the last partial one) shows.  After the window the plain
reference (``reference/<name>.py``, named by the configuration) computes
the same sites from the same inputs in float64, and every block is held
against it (a block whose rows equal an earlier block's of the same pool
entry bit for bit carries that block's copy, and is judged by it).

A cell's numbers are its limits file's (``limits/<cell>.json``): each
names the output it compares (``"scen"``, the adjusted series, or a
variable of the trained dataset), the measure (``measures/<name>.py``,
whose ``gap(got, want)`` reads the two) and its limit.  A block fails
when one of its numbers passes its limit, or when it raised.
"""

from __future__ import annotations

import numpy as np

from . import spec


def sample_sites(seed: int, pool_blocks: int, sites: int, strata: int) -> np.ndarray:
    """[pool_blocks, strata + 2] site indexes of each pool entry: the
    block's first site, one from each stratum, and its last site."""
    rng = np.random.default_rng([int(seed), 0x5A17])
    edges = np.linspace(0, sites, strata + 1).astype(np.int64)
    return np.stack([np.concatenate([[0], rng.integers(edges[:-1], edges[1:]), [sites - 1]]) for _ in range(pool_blocks)])


def outputs(numbers: dict) -> list[str]:
    """The outputs the numbers compare, each once."""
    return sorted({n["output"] for n in numbers.values()})


def compare(blocks: list[tuple[int, dict]], want: dict, numbers: dict, raised: int = 0, root=spec.ROOT) -> dict:
    """``blocks``: (pool entry, {output: sampled rows}) of every block run;
    ``want``: {pool entry: {output: the reference's rows}}; ``numbers``:
    the cell's limits file.  Returns the widest gap of each number over
    all blocks, the blocks that failed, and ``correct``."""
    gaps = {name: spec.module("measures", n["measure"], root).gap for name, n in numbers.items()}
    widest = {k: 0.0 for k in numbers}
    failed = raised
    judged = {}  # blocks whose rows are one object (see run.Cell.keep) are judged once
    for entry, got in blocks:
        key = (entry, id(got))
        if key not in judged:
            judged[key] = {name: gaps[name](got[n["output"]], want[entry][n["output"]]) for name, n in numbers.items()}
        over = False
        for name, g in judged[key].items():
            widest[name] = max(widest[name], g)
            over |= not g <= numbers[name]["limit"]
        failed += over
    attempted = len(blocks) + raised
    return {
        "attempted": attempted,
        "failed": failed,
        "correct": attempted > 0 and failed == 0,
        "compared": {k: {"value": widest[k], "limit": numbers[k]["limit"]} for k in numbers},
    }
