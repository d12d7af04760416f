"""Székely–Rizzo energy distance by the matrix-product factorisation.

Replaces the numba O(K·N·M) pairwise loops (reference ``nbutils.py:274-372``)
with ``‖x‖² + ‖y‖² − 2xᵀy``: the distance matrix is one batched
``torch.matmul`` (the JAX package leaves the same product to XLA, outside any
kernel).  NaN points (any variable NaN) are masked out with weights instead
of compressed, matching ``remove_NaNs`` semantics.

The distance matrix is [..., N, M]: all points of a 30-year daily series are
10950² values a site, three times an energy score.  The leading batch is
therefore walked in chunks of at most ``_BLOCK_BUDGET`` matrix elements (one
site at least); each site's sums are its own, so the result does not depend
on the chunking.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import as_tensor

__all__ = ["escore"]

# elements of the [chunk, N, M] distance block held at once (patchable for tests)
_BLOCK_BUDGET = 1 << 27


def _masked_pairwise_total(X, Y, mx, my):
    """Sum of euclidean distances between the valid columns of X [B, K, N]
    and Y [B, K, M]; mx/my are the 0/1 validity masks of the columns."""
    X0 = torch.where(mx[:, None, :] > 0, X, 0.0)
    Y0 = torch.where(my[:, None, :] > 0, Y, 0.0)
    x2 = (X0 * X0).sum(dim=-2)                               # [B, N]
    y2 = (Y0 * Y0).sum(dim=-2)                               # [B, M]
    d = torch.matmul(X0.transpose(-1, -2), Y0)               # [B, N, M]
    # (x2 + y2) - 2 xy, clipped at 0, square root, masked: in place on the one block
    d = torch.add(x2[:, :, None] + y2[:, None, :], d, alpha=-2, out=d)
    d.clamp_(min=0).sqrt_()
    d.mul_(mx[:, :, None]).mul_(my[:, None, :])
    return d.sum(dim=(-2, -1))


def _escore_flat(tgt, sim):
    mt = (~torch.isnan(tgt).any(dim=-2)).to(tgt.dtype)
    ms = (~torch.isnan(sim).any(dim=-2)).to(sim.dtype)
    n2 = mt.sum(dim=-1)
    n1 = ms.sum(dim=-1)
    one = torch.ones((), dtype=tgt.dtype, device=tgt.device)
    sXY = _masked_pairwise_total(tgt, sim, mt, ms) / torch.maximum(n1 * n2, one)
    # reference _autocorrelation divides by n^2 (includes the zero diagonal)
    sXX = _masked_pairwise_total(tgt, tgt, mt, mt) / torch.maximum(n2 * n2, one)
    sYY = _masked_pairwise_total(sim, sim, ms, ms) / torch.maximum(n1 * n1, one)
    w = n1 * n2 / torch.maximum(n1 + n2, one)
    out = w * (2 * sXY - sXX - sYY) / 2
    return torch.where((n1 == 0) | (n2 == 0), torch.nan, out)


def escore(tgt, sim):
    """Energy distance between clusters tgt [..., K, N] and sim [..., K, M]
    (reference ``nbutils.py:341-372``): ``w · (2·sXY − sXX − sYY) / 2`` with
    ``w = n1·n2/(n1+n2)``; columns with any NaN are excluded."""
    tgt = as_tensor(tgt)
    sim = as_tensor(sim, device=tgt.device)
    lead = torch.broadcast_shapes(tgt.shape[:-2], sim.shape[:-2])
    B = int(np.prod(lead, dtype=np.int64))
    t3 = tgt.expand(lead + tgt.shape[-2:]).reshape((B,) + tgt.shape[-2:])
    s3 = sim.expand(lead + sim.shape[-2:]).reshape((B,) + sim.shape[-2:])
    widest = max(t3.shape[-1], s3.shape[-1], 1)
    chunk = max(1, _BLOCK_BUDGET // (widest * widest))
    out = [_escore_flat(t3[b0 : b0 + chunk], s3[b0 : b0 + chunk]) for b0 in range(0, B, chunk)]
    flat = torch.cat(out) if out else t3.new_empty((0,))
    return flat.reshape(lead)
