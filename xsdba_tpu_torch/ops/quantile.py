"""NaN-aware batched quantiles.

Replaces the reference's numba kernels (``nbutils.py:24-271``): per-row sort +
type-7 (Hyndman-Fan; ``alpha=beta=1``) linear interpolation, NaN-aware.

One ``torch.sort`` over the reduced axis (NaNs sort last, like numpy), then a
vectorized gather + lerp — no Python-level row loop, any leading batch dims.
``torch.nanquantile`` is not used: its lerp is not the symmetric
:func:`_lerp` of the reference, so it differs in the last bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import as_tensor

__all__ = [
    "grouped_nan_quantile",
    "nan_quantile",
    "vecquantiles",
]


def _virtual_index(valid_count, quantiles, alpha: float, beta: float):
    # Reference nbutils.py:130: n*q + (alpha + q*(1-alpha-beta)) - 1
    return valid_count * quantiles + (alpha + quantiles * (1 - alpha - beta)) - 1


def _lerp(left, right, gamma):
    # Symmetric lerp for fp accuracy — mirrors nbutils.py:77-106.
    diff = right - left
    out = left + diff * gamma
    return torch.where(gamma >= 0.5, right - diff * (1 - gamma), out)


def _quantile_on_sorted(sorted_x, valid, quantiles, alpha, beta):
    """Type-7 quantiles given a pre-sorted (NaNs-last) last axis.

    sorted_x: [..., n]; valid: [...] count of non-NaN entries;
    quantiles: [..., nq] (broadcastable against leading dims).
    Returns [..., nq].
    """
    n = sorted_x.shape[-1]
    v = valid[..., None].to(sorted_x.dtype)
    # Bounds handling (nbutils.py:30-68): above valid-1 -> last element of the
    # *full* row (index -1, a NaN pad — later clipped to the max valid
    # value); below 0 -> first element.
    vi = _virtual_index(v, quantiles, alpha, beta)
    prev = torch.floor(vi)
    above = vi >= v - 1
    below = vi < 0
    last = torch.full_like(prev, n - 1, dtype=torch.int64)
    zero = torch.zeros_like(last)
    prev_idx = torch.clamp(prev, 0, n - 1).to(torch.int64)
    next_idx = torch.clamp(prev + 1, 0, n - 1).to(torch.int64)
    prev_idx = torch.where(above, last, torch.where(below, zero, prev_idx))
    next_idx = torch.where(above, last, torch.where(below, zero, next_idx))
    gamma = (vi - prev).to(sorted_x.dtype)

    lead = sorted_x.shape[:-1]
    take = lambda idx: torch.gather(sorted_x, -1, idx.expand(lead + idx.shape[-1:]))  # noqa: E731
    left = take(prev_idx)
    right = take(next_idx)
    max_idx = torch.clamp(valid[..., None] - 1, 0, n - 1).to(torch.int64)
    max_valid = take(max_idx)
    interp = _lerp(left, right, gamma)
    # NaN range clip: replace NaN interpolation by the max valid value
    # (nbutils.py:144-147).  All-NaN rows keep NaN (max_valid NaN there).
    return torch.where(torch.isnan(interp), max_valid, interp)


def nan_quantile(x, quantiles, axis: int = -1, alpha: float = 1.0, beta: float = 1.0):
    """NaN-aware quantiles along ``axis``; matches ``np.nanquantile`` for
    ``alpha=beta=1`` (reference ``nbutils.py:113-148``).

    ``quantiles`` is a 1-D array of nq probabilities.  The reduced axis is
    replaced by a trailing ``nq`` axis.
    """
    x = as_tensor(x)
    quantiles = as_tensor(quantiles, dtype=x.dtype, device=x.device)
    x = torch.movedim(x, axis, -1)
    sorted_x = torch.sort(x, dim=-1).values  # NaNs sort to the end
    valid = (~torch.isnan(x)).sum(dim=-1)
    return _quantile_on_sorted(sorted_x, valid, quantiles, alpha, beta)


def vecquantiles(x, ranks, axis: int = -1, alpha: float = 1.0, beta: float = 1.0):
    """Quantile where the probability differs per row (reference
    ``nbutils.py:151-195``): ``x`` [..., n], ``ranks`` [...] -> [...].

    NaN rank yields NaN.
    """
    x = as_tensor(x)
    ranks = as_tensor(ranks, dtype=x.dtype, device=x.device)
    x = torch.movedim(x, axis, -1)
    sorted_x = torch.sort(x, dim=-1).values
    valid = (~torch.isnan(x)).sum(dim=-1)
    q = torch.nan_to_num(ranks, nan=0.0)[..., None]
    out = _quantile_on_sorted(sorted_x, valid, q, alpha, beta)[..., 0]
    return torch.where(torch.isnan(ranks), torch.nan, out)


def grouped_nan_quantile(x, gather_idx, quantiles, alpha: float = 1.0, beta: float = 1.0, group_chunk: int | None = None):
    """Fused gather -> sort -> lerp grouped quantile.

    x: [..., T]; gather_idx: [G, L] int with -1 padding (see
    ``Grouper.indexes``); quantiles: [nq].  Returns [..., G, nq].

    The lowering of the reference's rolling-window groupby quantile
    (``base.py:261-265`` + ``nbutils.quantile``): window padding positions are
    -1 and become NaN, exactly like the NaN pads of ``rolling.construct``.

    ``group_chunk`` bounds peak memory: groups are processed ``group_chunk``
    at a time so only a [..., chunk, L] slice of the gather matrix is ever
    materialized.  By default a chunk keeps the slice near ~2^28 elements.
    """
    from .segment import gather_groups

    x = as_tensor(x)
    gi = as_tensor(gather_idx, device=x.device)
    G, L = gi.shape
    batch = int(np.prod(x.shape[:-1], dtype=np.int64)) if x.ndim > 1 else 1
    if group_chunk is None:
        budget = 1 << 28
        group_chunk = max(1, min(G, budget // max(batch * L, 1)))
    outs = [
        nan_quantile(gather_groups(x, gi[k : k + group_chunk]), quantiles, axis=-1, alpha=alpha, beta=beta)
        for k in range(0, G, group_chunk)
    ]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)
