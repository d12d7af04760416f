"""Distribution fitting: the Generalized Pareto half.

:func:`gpd_fit_ml` is a batched Generalized Pareto ML fit through the 1-D
profile likelihood (Grimshaw's reduction): the 2-D (shape, scale) MLE
reduces to maximizing ``l(θ) = −n[log(ξ(θ)/θ) + ξ(θ) + 1]`` with
``ξ(θ) = mean(log(1 + θx))``, found by a grid and golden-section steps,
NaN-aware and vectorized over the batch.  It replaces scipy's
``genpareto.fit`` in ExtremeValues' hot path (reference
``_adjustment.py:1060-1110``).  Its last golden-section decisions compare
profile likelihoods that differ by rounding noise near the flat optimum, so
the fit is fixed only to about the square root of the machine epsilon:
another summation order (the JAX package's, the card's) moves it by ~1e-8
in float64 and ~1e-3 in float32 (ROADMAP C18).  The GEV fits, L-moments and the scipy
dispatch of the JAX package's ``ops/fitting.py`` serve the diagnostics and
are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import as_tensor
from .cuda.fma_kernel import fma

__all__ = ["gpd_cdf", "gpd_fit_ml", "gpd_ppf"]

_GOLDEN = (np.sqrt(5) - 1) / 2


def gpd_cdf(x, c, loc, scale):
    """Generalized Pareto CDF (scipy parametrization: shape ``c``).
    ``1 + c * z`` is rounded once, as the JAX package's compiled callers
    round it."""
    z = torch.clamp((x - loc) / scale, min=0)
    safe_c = torch.where(c == 0, 1.0, c)
    body = 1 - fma(safe_c.expand_as(z), z, torch.ones_like(z)) ** (-1 / safe_c)
    out = torch.where(c == 0, 1 - torch.exp(-z), body)
    # c < 0: the support ends at z = -1 / c
    return torch.where((c < 0) & (z >= -1 / safe_c), 1.0, out)


def gpd_ppf(q, c, loc, scale):
    """Generalized Pareto quantile function; ``loc + scale * z`` is rounded
    once."""
    safe_c = torch.where(c == 0, 1.0, c)
    body = ((1 - q) ** (-safe_c) - 1) / safe_c
    z = torch.where(c == 0, -torch.log1p(-q), body)
    shape = torch.broadcast_shapes(z.shape, scale.shape, loc.shape)
    return fma(scale.expand(shape), z.expand(shape), loc.expand(shape))


def _grid_nodes(n_grid: int) -> tuple[np.ndarray, np.ndarray]:
    """The grid's unscaled nodes in float64: the JAX package's
    ``linspace(0.999, 1e-8, n_grid // 2)`` and ``logspace(-6, 3, n_grid -
    n_grid // 2)`` by their formula (``start * (1 - s) + stop * s`` at ``s =
    i / (n - 1)``, the last node ``stop``; ``10 ** node``).  XLA's compiled
    constants differ from these by an ulp at some nodes (ROADMAP C18)."""

    def lin(start, stop, n):
        s = np.arange(n - 1, dtype=np.float64) / (n - 1)
        return np.append(start * (1 - s) + stop * s, stop)

    n_neg = n_grid // 2
    return lin(0.999, 1e-8, n_neg), np.power(10.0, lin(-6.0, 3.0, n_grid - n_neg))


def gpd_fit_ml(x, *, n_grid: int = 120, n_iter: int = 40):
    """Batched GPD ML fit of x [..., N] (NaN padded, values > 0, loc = 0).

    Returns ``(c, scale)`` [...].  θ = c / σ; ξ(θ) = mean(log1p(θx)) over
    the valid values; ``l(θ)`` is maximized over θ in (−1/max(x), inf), θ ≠ 0,
    by a grid of ``n_grid`` nodes (half on the negative side, half
    log-spaced on the positive side) and ``n_iter`` golden-section steps
    around the best node; the grid is evaluated at once, [..., N, n_grid]
    temporaries (0.7 GB each at [512, 2882] in float32).  Rows with no
    valid value give NaN.
    """
    x = as_tensor(x)
    valid = ~torch.isnan(x) & (x > 0)
    n = valid.sum(dim=-1)
    n_div = torch.clamp(n, min=1).to(x.dtype)
    x0 = torch.where(valid, x, 0.0)
    xmax = torch.where(valid, x, -torch.inf).amax(dim=-1)
    xmean = torch.nanmean(torch.where(valid, x, torch.nan), dim=-1)

    def neg_prof(theta):
        """theta [..., K] -> profile negative log-likelihood [..., K]."""
        lx = torch.log1p(theta[..., None, :] * x0[..., None])            # [..., N, K]
        xi = torch.where(valid[..., None], lx, 0.0).sum(dim=-2) / n_div[..., None]
        sigma = xi / theta                       # needs xi and theta of one sign
        bad = (sigma <= 0) | ~torch.isfinite(xi)
        ll = -(torch.log(torch.where(bad, 1.0, sigma)) + xi + 1)
        return torch.where(bad | ~torch.isfinite(ll), torch.inf, -ll)

    eps = 1e-8
    neg, pos = (torch.as_tensor(a, dtype=x.dtype, device=x.device) for a in _grid_nodes(n_grid))
    grid = torch.cat([-neg / torch.clamp(xmax, min=eps)[..., None], pos / torch.clamp(xmean, min=eps)[..., None]], dim=-1)
    best = torch.argmin(neg_prof(grid), dim=-1, keepdim=True)
    a = torch.gather(grid, -1, torch.clamp(best - 1, 0, n_grid - 1))
    b = torch.gather(grid, -1, torch.clamp(best + 1, 0, n_grid - 1))

    gr = torch.tensor(_GOLDEN, dtype=x.dtype, device=x.device)
    for _ in range(n_iter):
        d = b - a
        c1 = fma(-gr.expand_as(d), d, b)
        c2 = fma(gr.expand_as(d), d, a)
        left = neg_prof(c1) < neg_prof(c2)
        a, b = torch.where(left, a, c1), torch.where(left, c2, b)
    theta = (a + b)[..., 0] / 2

    lx = torch.log1p(theta[..., None] * x0)
    xi = torch.where(valid, lx, 0.0).sum(dim=-1) / n_div
    empty = n == 0
    return torch.where(empty, torch.nan, xi), torch.where(empty, torch.nan, xi / theta)
