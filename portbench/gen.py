"""The one generator of every cell's data, from a seed.

A cell's configuration names its data (``"generator"``: the module
``portbench/generators/<name>.py``, whose ``make_block(g, assumed, sites,
days, device, dtype)`` returns the block's named inputs, sites first, and
whose ``DIMS`` names their dimensions); its mix fixes the sizes (sites a
block, the training and sim periods, the blocks of the pool) and may mask
values, which applies to any configuration's data:

- ``nan_sites``: the share of each block's sites whose every value is NaN
  in every input (a land-sea mask); the count is fixed, which sites from
  the seed;
- ``nan_values``: the share of the other values that are NaN, each drawn
  from the seed (missing days).

One ``torch.Generator`` on the device, seeded with ``--seed``, draws every
block in turn, so the same seed gives the same pool, and every seed the
same sizes.
"""

from __future__ import annotations

import torch

from . import spec


def make_pool(seed: int, config: dict, mix: dict, days: dict, device, dtype, root=spec.ROOT) -> list[dict]:
    """``mix["pool_blocks"]`` distinct blocks of ``config``'s data."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    make = spec.module("generators", config["generator"], root).make_block
    sites = int(mix["sites_per_block"])
    return [mask(g, make(g, config["assumed"], sites, days, device, dtype), mix) for _ in range(int(mix["pool_blocks"]))]


def mask(g: torch.Generator, block: dict, mix: dict) -> dict:
    """The block with the mix's NaN masks applied (see the module docstring)."""
    n_sites = round(float(mix.get("nan_sites", 0)) * next(iter(block.values())).shape[0])
    share = float(mix.get("nan_values", 0))
    if not n_sites and not share:
        return block
    first = next(iter(block.values()))
    dead = torch.randperm(first.shape[0], generator=g, device=first.device)[:n_sites]
    out = {}
    for name, x in block.items():
        x = x.clone()
        if share:
            x[torch.rand(x.shape, generator=g, device=x.device) < share] = float("nan")
        x[dead] = float("nan")
        out[name] = x
    return out
