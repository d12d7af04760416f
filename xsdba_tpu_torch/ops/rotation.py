"""Random rotation matrices — SO(N) via QR (Mezzadri 2007).

Reference ``utils.py:924-974``, with the port's explicit generator stream
(``utils/rng.py``) in place of the global numpy RNG.
"""

from __future__ import annotations

import torch

from ..utils import rng

__all__ = ["rand_rot_matrix"]


def rand_rot_matrix(n: int, num: int = 1, generator: torch.Generator | None = None, dtype=torch.float32, device=None):
    """Generate ``num`` random rotation matrices of size n x n.

    Haar-uniform over O(n): QR of a standard normal matrix with the sign
    fix ``Q · diag(r_ii/|r_ii|)`` (reference utils.py:963-974), drawn and
    orthogonalised in ``dtype`` (a float32 QR cast up would be orthogonal
    only to ~1e-7).  ``generator`` defaults to the global stream's on
    ``device`` (``utils/rng.py``; the CPU unless a device is given).
    Returns [num, n, n] (or [n, n] if num == 1).
    """
    gen = rng.next_generator(device) if generator is None else generator
    Z = torch.randn((num, n, n), generator=gen, dtype=dtype, device=gen.device)
    Q, R = torch.linalg.qr(Z)
    d = torch.diagonal(R, dim1=-2, dim2=-1)
    out = Q * (d / d.abs())[..., None, :]
    return out[0] if num == 1 else out
