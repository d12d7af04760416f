"""Group-wise apply primitives over static gather/scatter indexes.

The replacement for ``Grouper.apply`` (reference ``base.py:347-457``):
instead of a runtime groupby, values are gathered into a dense ``[G, L]``
matrix (NaN-padded via the -1 indexes), reduced or transformed along ``L``,
and — for transforms — scattered back to the time axis through
``(group_idx[t], scatter_slot[t])`` (the window-center selection of
``base.py:425-430``).
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from ..utils.tensor import as_tensor, nanmax, nanmin, nanstd
from .cuda import rank_kernel
from .rank import average_rank

__all__ = [
    "gather_groups",
    "grouped_mean",
    "grouped_rank",
    "grouped_rank_and_quantile",
    "grouped_rank_reference",
    "grouped_std",
    "scatter_back",
]


def _index(idx, device) -> torch.Tensor:
    return as_tensor(idx, device=device).long()


def gather_groups(x, gather_idx):
    """x [..., T], gather_idx [G, L] -> [..., G, L] with NaN where idx < 0."""
    x = as_tensor(x)
    gi = _index(gather_idx, x.device)
    vals = x[..., torch.clamp(gi, 0, x.shape[-1] - 1)]
    return torch.where(gi < 0, torch.nan, vals)


def scatter_back(grouped_vals, group_idx, scatter_slot):
    """grouped_vals [..., G, L] -> [..., T] via per-timestep (group, slot)."""
    dev = grouped_vals.device
    return grouped_vals[..., _index(group_idx, dev), _index(scatter_slot, dev)]


def grouped_mean(x, gather_idx):
    """NaN-aware per-group mean: [..., T] -> [..., G]."""
    return torch.nanmean(gather_groups(x, gather_idx), dim=-1)


def grouped_std(x, gather_idx, ddof: int = 0):
    """NaN-aware per-group standard deviation: [..., T] -> [..., G]."""
    return nanstd(gather_groups(x, gather_idx), axis=-1, ddof=ddof)


def grouped_rank(x, gather_idx, group_idx, scatter_slot, pct: bool = False):
    """Rank each value within its (windowed) group, written back to time.

    Matches reference ``group.apply(u.rank, da, pct=True)`` (utils.py:575-638):
    average ranks within the group block; with ``pct`` the ranks are divided by
    the valid count then rescaled to span [0, 1] (utils.py:631-634).
    A CUDA tensor whose groups fit the hand-written kernel
    (``ops/cuda/rank_kernel.py:fits``: float32 or float64, at most
    ``MAX_ROW`` slots a group) takes it, one launch; any other takes
    :func:`grouped_rank_reference`.  The span ``rank``.
    """
    with span("rank"):
        x = as_tensor(x)
        if rank_kernel.fits(x.device.type, x.dtype, gather_idx.shape[-1]):
            return rank_kernel.grouped_rank(x, gather_idx, group_idx, scatter_slot, pct)
        return grouped_rank_reference(x, gather_idx, group_idx, scatter_slot, pct)


def grouped_rank_reference(x, gather_idx, group_idx, scatter_slot, pct: bool = False):
    """:func:`grouped_rank` in plain PyTorch, on any device and row length:
    a gather into the NaN-padded [..., G, L] slab, ``average_rank`` (one
    stable sort, two ``cummax`` scans, a scatter), the pct rescale, and
    :func:`scatter_back`.  The CUDA kernel's twin."""
    v = gather_groups(x, gather_idx)           # [..., G, L]
    rnk = average_rank(v, axis=-1)
    if pct:
        nvalid = (~torch.isnan(v)).sum(dim=-1, keepdim=True).to(rnk.dtype)
        rnk = rnk / torch.where(nvalid == 0, 1, nvalid)
        mn = nanmin(rnk, axis=-1, keepdims=True)
        mx = nanmax(rnk, axis=-1, keepdims=True)
        denom = torch.where(mx - mn == 0, 1, mx - mn)
        rnk = mx * (rnk - mn) / denom
    return scatter_back(rnk, group_idx, scatter_slot)


def grouped_rank_and_quantile(x, gather_idx, group_idx, scatter_slot, quantiles):
    """Fused ``grouped_rank(pct=True)`` + per-group quantile tables.

    One gather and ONE value sort serve both.  Numerically identical to
    ``grouped_rank(x, ..., pct=True)`` plus
    ``nan_quantile(gather_groups(x, gather_idx), quantiles)`` — the
    NpdfTransform/QDM pattern (reference ``_adjustment.py:820-846``).

    Returns ``(pct ranks scattered back to time [..., T],
    quantile tables [..., G, nq])``.
    """
    from .quantile import _quantile_on_sorted
    from .rank import rank_pct_rescaled_with_sorted

    v = gather_groups(x, gather_idx)            # [..., G, L]
    rnk, sorted_v, nvalid = rank_pct_rescaled_with_sorted(v, axis=-1)
    q = as_tensor(quantiles, dtype=sorted_v.dtype, device=sorted_v.device)
    qtab = _quantile_on_sorted(sorted_v, nvalid, q, 1.0, 1.0)
    return scatter_back(rnk, group_idx, scatter_slot), qtab
