"""Average ranks with NaN handling.

Replicates xarray/bottleneck ``nanrankdata`` semantics used by the reference
(``utils.py:575-646``): equal values get the average of their would-be ranks,
ranks start at 1, NaNs stay NaN; ``pct`` divides by the valid count.  The
reference then rescales pct ranks to span [0, 1] exactly
(``rnk = mx*(rnk-mn)/(mx-mn)``, ``utils.py:631-634``), which we reproduce.

Implementation: one stable sort + cumulative-max run labeling.  Equal values
form contiguous runs in the sorted order, and the average of consecutive
integer positions a..b is just (a+b)/2 — so tie-averaged ranks come from two
cummax scans over the sorted row; a scatter along the sort permutation puts
them back in place.
"""

from __future__ import annotations

import torch

from ..utils.tensor import as_tensor, nanmax, nanmin

__all__ = ["average_rank", "pct_rank", "rank_pct_rescaled", "rank_pct_rescaled_with_sorted"]


def _rank_core(x):
    """Shared internals on a last-axis layout: returns
    (avg ranks [NaN where x is NaN], sorted values with NaNs last, NaN mask).

    ``torch.sort`` orders NaN after every number, genuine +inf included, so
    the sorted row's NaN mask is its NaN tail.  NaNs are keyed as +inf but
    kept out of the +inf tie run by that mask (ROADMAP trap C1: a lone +inf
    next to the NaN block would otherwise be averaged over the NaN
    positions).  The unsort is a scatter along the permutation.
    """
    n = x.shape[-1]
    nan = torch.isnan(x)
    sorted_x, perm = torch.sort(x, dim=-1, stable=True)
    snan = torch.isnan(sorted_x)
    s = torch.where(snan, torch.inf, sorted_x)
    pos = torch.arange(n, device=x.device)
    prev = torch.cat([torch.full_like(s[..., :1], torch.nan), s[..., :-1]], dim=-1)
    snan_i = snan.to(torch.int8)
    prev_nan = torch.cat([torch.full_like(snan_i[..., :1], -1), snan_i[..., :-1]], dim=-1)
    starts = (s != prev) | (snan_i != prev_nan)  # first slot of each tie-run
    a = torch.cummax(torch.where(starts, pos, -1), dim=-1).values
    nxt = torch.cat([starts[..., 1:], torch.ones_like(starts[..., :1])], dim=-1)
    b = -torch.cummax(-torch.where(nxt, pos, n).flip(-1), dim=-1).values.flip(-1)
    avg_sorted = (a + b).to(x.dtype) / 2 + 1
    rnk = torch.empty_like(avg_sorted).scatter_(-1, perm, avg_sorted)
    rnk = torch.where(nan, torch.nan, rnk)
    return rnk, sorted_x, nan


def average_rank(x, axis: int = -1):
    """Average rank along ``axis``; NaNs -> NaN; ranks start at 1."""
    x = torch.movedim(as_tensor(x), axis, -1)
    rnk, _, _ = _rank_core(x)
    return torch.movedim(rnk, -1, axis)


def _rescale(r):
    mn = nanmin(r, axis=-1, keepdims=True)
    mx = nanmax(r, axis=-1, keepdims=True)
    denom = mx - mn
    return torch.where(denom == 0, 0.0, mx * (r - mn) / torch.where(denom == 0, 1, denom))


def rank_pct_rescaled_with_sorted(x, axis: int = -1):
    """``rank_pct_rescaled`` plus the value-sorted row (NaNs last) and valid
    counts, all from ONE value sort.

    Returns ``(rescaled pct ranks, sorted values, valid counts)`` — sorted
    values/counts in last-axis layout, ready for
    ``ops.quantile._quantile_on_sorted``.
    """
    x = torch.movedim(as_tensor(x), axis, -1)
    rnk, sorted_x, nan = _rank_core(x)
    nvalid = (~nan).sum(dim=-1, keepdim=True).to(rnk.dtype)
    r = rnk / torch.where(nvalid == 0, 1, nvalid)
    return torch.movedim(_rescale(r), -1, axis), sorted_x, nvalid[..., 0]


def pct_rank(x, axis: int = -1):
    """Percentage rank in (0, 1]: rank / n_valid (xarray ``rank(pct=True)``)."""
    x = as_tensor(x)
    rnk = average_rank(x, axis=axis)
    nvalid = (~torch.isnan(x)).sum(dim=axis, keepdim=True).to(rnk.dtype)
    return rnk / torch.where(nvalid == 0, 1, nvalid)


def rank_pct_rescaled(x, axis: int = -1):
    """Reference pct rank: rescaled so min -> 0 and max -> mx
    (``utils.py:631-634``: ``mx*(rnk-mn)/(mx-mn)``)."""
    r = torch.movedim(pct_rank(x, axis=axis), axis, -1)
    return torch.movedim(_rescale(r), -1, axis)
