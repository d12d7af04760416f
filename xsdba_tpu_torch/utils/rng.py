"""Deterministic randomness.

The reference uses the unseeded global numpy RNG (rotation matrices, jitter,
OT draws); the JAX package keeps a process-global Threefry key.  The port
keeps a process-global stream of ``torch.Generator`` objects, one per device,
created lazily on the device asked for and seeded with the stream's seed (0
until :func:`seed` changes it).  A ``torch.Generator`` cannot reproduce the
JAX package's draws: parity tests hand both packages the same numbers.
"""

from __future__ import annotations

import torch

__all__ = ["next_generator", "seed"]

# nothing is created at import time: a CUDA generator would initialise the
# card as a side effect of `import xsdba_tpu_torch`
_state: dict = {"seed": 0, "generators": {}}


def seed(s: int) -> None:
    """Seed the global stream: every device's generator restarts from ``s``."""
    _state["seed"] = int(s)
    _state["generators"].clear()


def next_generator(device=None) -> torch.Generator:
    """The stream's generator on ``device`` (the CPU by default); draws
    advance it, so consecutive draws differ and :func:`seed` replays them."""
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = _state["generators"].get(dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_state["seed"])
        _state["generators"][dev] = gen
    return gen

