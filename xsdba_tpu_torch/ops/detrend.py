"""Batched polynomial trend fitting.

Port of ``xsdba_tpu/ops/detrend.py`` (the xarray ``polyfit``/``polyval`` of
reference ``detrending.py:196-208``): masked normal equations, one small
``[deg+1, deg+1]`` solve a (batch, group), no loop over sites.

The x axis is rescaled to [-1, 1] per row before fitting, as the JAX
package does it; the evaluated trend is invariant under the rescaling and
far better conditioned than raw epoch coordinates.
"""

from __future__ import annotations

import torch

from ..utils.tensor import as_tensor, nanmax, nanmin
from .segment import gather_groups, scatter_back

__all__ = ["grouped_polyfit_trend", "polyfit_trend"]


def _vander(x, degree: int):
    return torch.stack([x**k for k in range(degree + 1)], dim=-1)  # [..., n, d+1]


def polyfit_trend(y, x, *, degree: int):
    """Fit a polynomial of ``degree`` to y ([..., n]) over x ([n] or
    [..., n]), NaN-aware, and evaluate it at x.  Returns the trend [..., n];
    rows with no valid value give NaN."""
    y = as_tensor(y)
    x = as_tensor(x, dtype=y.dtype, device=y.device).expand(y.shape)
    # rescale to [-1, 1] (NaN-x entries excluded)
    valid = ~(torch.isnan(y) | torch.isnan(x))
    xv = torch.where(valid, x, torch.nan)
    lo = nanmin(xv, axis=-1, keepdims=True)
    hi = nanmax(xv, axis=-1, keepdims=True)
    span = torch.where(hi > lo, hi - lo, 1.0)
    xs = (torch.where(torch.isnan(x), 0.0, x) - lo) / span * 2 - 1

    V = _vander(xs, degree)                       # [..., n, d+1]
    Vw = V * valid.to(y.dtype)[..., None]
    yv = torch.where(valid, y, 0.0)
    A = Vw.transpose(-1, -2) @ V
    b = (Vw.transpose(-1, -2) @ yv[..., None])
    # a ridge epsilon guards rank-deficient rows; solve_ex does not check
    # for singular systems, so it never waits for the device
    A = A + torch.eye(degree + 1, dtype=y.dtype, device=y.device) * 1e-12
    coef = torch.linalg.solve_ex(A, b).result      # [..., d+1, 1]
    trend = (V @ coef)[..., 0]
    # rows with no valid value: NaN
    return torch.where(valid.any(dim=-1, keepdim=True), trend, torch.nan)


def grouped_polyfit_trend(y, x, gather_idx, group_idx, scatter_slot, *, degree: int):
    """Per-group polynomial trend written back to the time axis.

    y: [..., T]; x: [T] numeric time coordinate; gather/scatter indexes from
    ``Grouper.indexes`` (the group.apply(polyfit) of reference
    ``detrending.py:196-208``)."""
    y = as_tensor(y)
    yg = gather_groups(y, gather_idx)                                      # [..., G, L]
    xg = gather_groups(as_tensor(x, dtype=y.dtype, device=y.device), gather_idx)  # [G, L]
    return scatter_back(polyfit_trend(yg, xg, degree=degree), group_idx, scatter_slot)
