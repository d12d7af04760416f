"""Distribution fitting.

Three tiers, as in the JAX package:

- :func:`gpd_fit_ml` — a batched Generalized Pareto ML fit through the 1-D
  profile likelihood (Grimshaw's reduction): the 2-D (shape, scale) MLE
  reduces to maximizing ``l(θ) = −n[log(ξ(θ)/θ) + ξ(θ) + 1]`` with
  ``ξ(θ) = mean(log(1 + θx))``, found by a grid and golden-section steps,
  NaN-aware and vectorized over the batch.  It replaces scipy's
  ``genpareto.fit`` in ExtremeValues' hot path (reference
  ``_adjustment.py:1060-1110``).  Its last golden-section decisions compare
  profile likelihoods that differ by rounding noise near the flat optimum,
  so the fit is fixed only to about the square root of the machine
  epsilon: another summation order (the JAX package's, the card's) moves
  it by ~1e-8 in float64 and ~1e-3 in float32 (ROADMAP C18).
- the diagnostics' batched fits on tensors: the GEV by probability-weighted
  moments (:func:`gev_fit_pwm`), maximum likelihood (:func:`gev_fit_ml`, a
  damped Newton with a closed-form gradient and Hessian) and the method of
  moments (:func:`gev_fit_mm`, a bisection), :func:`gev_ppf`, the
  vectorized ``scipy.stats.linregress`` (:func:`linregress_field`) and the
  regularized incomplete beta function (:func:`betainc`), which PyTorch
  lacks;
- :func:`fit_scipy` — the host-side scipy dispatch (ML/MM/PWM/APP) with the
  reference's starting values (``utils.py:1164-1296``) and the L-moment
  estimators, for exotic distributions fit once per series.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import as_tensor
from .cuda.fma_kernel import fma

__all__ = [
    "PWM_SUPPORTED",
    "betainc",
    "fit_scipy",
    "gev_fit_ml",
    "gev_fit_mm",
    "gev_fit_pwm",
    "gev_ppf",
    "gpd_cdf",
    "gpd_fit_ml",
    "gpd_ppf",
    "linregress_field",
    "sample_lmoments",
]

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


# ---------------------------------------------------------------------------
# batched GEV (the diagnostics: return_value over many sites)
# ---------------------------------------------------------------------------

_EULER = 0.5772156649015329
_WMIN = 1e-8        # the likelihood's floor on 1 - c s; a quadratic barrier below it
_BARRIER = 1e6


def gev_ppf(q, c, loc, scale):
    """GEV quantile function (scipy ``genextreme`` parametrization), in the
    parameters' dtype.  The JAX package evaluates ``-log(q)`` in its default
    float (float64 where 64-bit mode is on) and promotes to it."""
    y = -torch.log(torch.as_tensor(q, dtype=c.dtype, device=c.device))
    small = c.abs() < 1e-12
    safe_c = torch.where(small, 1.0, c)
    z = torch.where(small, -torch.log(y), (1.0 - y**safe_c) / safe_c)
    return loc + scale * z


def gev_fit_pwm(x):
    """Batched probability-weighted-moment GEV fit of x [..., N] (NaN-aware).

    Hosking et al. (1985) L-moment estimators, the closed-form analogue of
    the reference's ``lmoments3`` PWM path (``utils.py:1164-1193``).  Returns
    ``(c, loc, scale)`` in scipy's ``genextreme`` convention; rows with
    fewer than 3 valid values give NaN (a GEV has 3 parameters).
    """
    x = as_tensor(x)
    xs = torch.sort(x, dim=-1, stable=True).values  # NaNs sort to the end
    N = x.shape[-1]
    valid = ~torch.isnan(xs)
    nf = valid.sum(dim=-1).to(xs.dtype)
    j = torch.arange(1, N + 1, dtype=xs.dtype, device=xs.device)
    v = torch.where(valid, xs, 0.0)
    d1 = torch.clamp(nf - 1, min=1.0)[..., None]
    d2 = torch.clamp((nf - 1) * (nf - 2), min=1.0)[..., None]
    nfs = torch.clamp(nf, min=1.0)
    b0 = v.sum(dim=-1) / nfs
    b1 = (v * (j - 1) / d1).sum(dim=-1) / nfs
    b2 = (v * (j - 1) * (j - 2) / d2).sum(dim=-1) / nfs
    l1, l2, l3 = b0, 2 * b1 - b0, 6 * b2 - 6 * b1 + b0
    t3 = l3 / torch.where(l2 == 0, 1.0, l2)
    z = 2.0 / (3.0 + t3) - np.log(2.0) / np.log(3.0)
    k = 7.8590 * z + 2.9554 * z * z
    small = k.abs() < 1e-8
    ks = torch.where(small, 1.0, k)
    gam = torch.exp(torch.lgamma(1.0 + ks))
    scale = torch.where(small, l2 / np.log(2.0), l2 * ks / ((1.0 - 2.0 ** (-ks)) * gam))
    loc = torch.where(small, l1 - _EULER * scale, l1 - scale * (1.0 - gam) / ks)
    bad = nf < 3
    return tuple(torch.where(bad, torch.nan, a) for a in (k, loc, scale))


def _gev_nll(params, x, valid):
    """Masked GEV negative log-likelihood at ``params`` [..., 3] = (c, loc,
    log scale) of the rows x [..., N] (``valid`` their mask), with a smooth
    quadratic barrier outside the support; a non-finite total is +inf."""
    c, mu, logs = params[..., 0:1], params[..., 1:2], params[..., 2:3]
    s = (torch.where(valid, x, mu) - mu) * torch.exp(-logs)
    w = 1.0 - c * s
    logw = torch.log(torch.clamp(w, min=_WMIN))
    smallc = c.abs() < 1e-9
    invc = 1.0 / torch.where(smallc, 1.0, c)
    general = logs - (invc - 1.0) * logw + torch.exp(invc * logw)
    gumbel = logs + s + torch.exp(-s)
    pt = torch.where(smallc, gumbel, general) + _BARRIER * torch.clamp(_WMIN - w, min=0.0) ** 2
    total = torch.where(valid, pt, 0.0).sum(dim=-1)
    return torch.where(torch.isfinite(total), total, torch.inf)


def _gev_nll_derivatives(p, x, valid, total):
    """Gradient [B, 3] and Hessian [B, 3, 3] of :func:`_gev_nll` at p [B, 3],
    in closed form over the rows x [B, N]; ``total`` is the likelihood at p.

    With e = exp(-log scale), s = (x - loc) e and w = 1 - c s, a point adds
    ``log scale - (u - 1) L + exp(u L)`` (u = 1/c, L = log max(w, 1e-8)), or
    ``log scale + s + exp(-s)`` where |c| < 1e-9, plus ``1e6 max(1e-8 - w,
    0)^2``; the chain rule through u(c), L(w) and w, s(c, loc, log scale)
    gives the terms below, the parameters' derivatives stacked on a
    dimension of 3 (first) and 3 x 3 (second) so that a step is a few dozen
    tensor operations (``max``'s derivative taken as 1 above the floor and
    0 below it).  Where the total is not finite both are 0 times their
    value, as reverse-mode differentiation of the total's ``where`` gives.
    """
    c, mu, logs = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    e = torch.exp(-logs)
    s = (torch.where(valid, x, mu) - mu) * e
    w = 1.0 - c * s
    zero, ce = torch.zeros_like(s), (c * e).expand_as(s)
    e = e.expand_as(s)
    # derivatives in the order (c, loc, log scale): [B, 3, N] and [B, 3, 3, N]
    s_d = torch.stack([zero, -e, -s], dim=1)
    w_d = torch.stack([-s, ce, c * s], dim=1)
    s_dd = torch.stack([zero, zero, zero, zero, zero, e, zero, e, s], dim=1).unflatten(1, (3, 3))
    w_dd = torch.stack([zero, e, s, e, zero, -ce, s, -ce, -c * s], dim=1).unflatten(1, (3, 3))
    outer = lambda a, b: a[:, :, None] * b[:, None, :]  # noqa: E731

    smallc = (c.abs() < 1e-9)[..., None]
    u = 1.0 / torch.where(c.abs() < 1e-9, 1.0, c)
    above = w > _WMIN
    L = torch.log(torch.clamp(w, min=_WMIN))
    E = torch.exp(u * L)
    pt_L, pt_u = u * E - (u - 1.0), L * (E - 1.0)
    pt_LL, pt_uu, pt_uL = u * u * E, L * L * E, E - 1.0 + u * L * E
    w_safe = torch.where(above, w, 1.0)
    L_w = torch.where(above, 1.0 / w_safe, 0.0)
    L_ww = torch.where(above, -1.0 / (w_safe * w_safe), 0.0)
    L_d = L_w[:, None] * w_d
    u_d = torch.cat([-u * u, torch.zeros_like(u), torch.zeros_like(u)], dim=1)[..., None]      # u depends on c alone
    u_dd = torch.zeros(p.shape[0], 3, 3, 1, dtype=p.dtype, device=p.device)
    u_dd[:, 0, 0] = 2.0 * u**3
    G_s, G_ss = 1.0 - torch.exp(-s), torch.exp(-s)
    r = torch.clamp(_WMIN - w, min=0.0)
    B_w, B_ww = -2.0 * _BARRIER * r, 2.0 * _BARRIER * (w < _WMIN).to(w.dtype)
    w_ww = outer(w_d, w_d)

    general = pt_L[:, None] * L_d + pt_u[:, None] * u_d
    grad = torch.where(smallc, G_s[:, None] * s_d, general) + B_w[:, None] * w_d
    L_dd = L_ww[:, None, None] * w_ww + L_w[:, None, None] * w_dd
    general = (pt_LL[:, None, None] * outer(L_d, L_d) + pt_L[:, None, None] * L_dd
               + pt_uL[:, None, None] * (outer(u_d, L_d) + outer(L_d, u_d)) + pt_uu[:, None, None] * outer(u_d, u_d) + pt_u[:, None, None] * u_dd)
    gumbel = G_ss[:, None, None] * outer(s_d, s_d) + G_s[:, None, None] * s_dd
    hess = torch.where(smallc[..., None], gumbel, general) + B_ww[:, None, None] * w_ww + B_w[:, None, None] * w_dd
    g = torch.where(valid[:, None], grad, 0.0).sum(dim=-1)
    g[:, 2] += valid.sum(dim=-1)                      # d(log scale) / d(log scale) at every valid point
    h = torch.where(valid[:, None, None], hess, 0.0).sum(dim=-1)
    finite = torch.isfinite(total)[:, None]
    return torch.where(finite, g, 0.0 * g), torch.where(finite[..., None], h, 0.0 * h)


def gev_fit_ml(x, *, n_iter: int = 40):
    """Batched maximum-likelihood GEV fit of x [..., N] (NaN padded).

    A damped Newton on (c, loc, log scale) from the PWM start (c clipped to
    [-0.9, 0.9]), the vectorized counterpart of scipy ``genextreme.fit`` in
    the reference's ``return_value`` (``properties.py:1258-1307``): each of
    the ``n_iter`` steps solves ``(H + lam I) d = g`` (``lam = 1e-6 max(1,
    max |diag H|)``; ``g / |g|`` where d is not finite) and keeps the best of
    the 9 points ``p - a d``, a = 1, 1/2, ..., 1/128 and 0 (the first on
    ties).  The gradient and Hessian are closed-form
    (:func:`_gev_nll_derivatives`), where the JAX package differentiates the
    likelihood automatically: no autodiff tape, and one stacked reduction a
    step.  Near a flat optimum the last steps follow rounding noise, so the
    fit is fixed only to about sqrt(eps) (ROADMAP C20).  Returns ``(c, loc,
    scale)``; rows with fewer than 3 valid values give NaN.
    """
    x = as_tensor(x)
    batch, N = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, N)
    valid = ~torch.isnan(xf)
    c0, loc0, scale0 = gev_fit_pwm(xf)
    c0 = torch.clamp(torch.nan_to_num(c0, nan=0.1), -0.9, 0.9)
    p = torch.stack([c0, torch.nan_to_num(loc0, nan=0.0), torch.log(torch.clamp(torch.nan_to_num(scale0, nan=1.0), min=1e-12))], dim=-1)
    alphas = torch.cat([2.0 ** -torch.arange(8.0, dtype=x.dtype, device=x.device), torch.zeros(1, dtype=x.dtype, device=x.device)])
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    total = _gev_nll(p, xf, valid)
    for _ in range(n_iter):
        g, h = _gev_nll_derivatives(p, xf, valid, total)
        lam = 1e-6 * torch.clamp(torch.diagonal(h, dim1=-2, dim2=-1).abs().amax(dim=-1), min=1.0)
        d, info = torch.linalg.solve_ex(h + lam[:, None, None] * eye, g)
        d = torch.where((info != 0)[:, None], torch.nan, d)
        gnorm = torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-30)
        d = torch.where(torch.isfinite(d).all(dim=-1, keepdim=True), d, g / gnorm)
        cand = p[:, None, :] - alphas[None, :, None] * d[:, None, :]                  # [B, 9, 3]
        vals = _gev_nll(cand, xf[:, None, :], valid[:, None, :])
        best = torch.argmin(vals, dim=-1, keepdim=True)
        p = torch.gather(cand, 1, best[..., None].expand(-1, 1, 3))[:, 0]
        total = torch.gather(vals, 1, best)[:, 0]
    bad = valid.sum(dim=-1) < 3
    c, loc, scale = p[:, 0], p[:, 1], torch.exp(p[:, 2])
    return tuple(torch.where(bad, torch.nan, a).reshape(batch) for a in (c, loc, scale))


def _gev_skew(c):
    """Skewness of a GEV with scipy shape ``c`` (vectorized, c > -1/3),
    evaluated away from the 0/0 point at c = 0 by a tiny nudge."""
    c = torch.where(c.abs() < 1e-6, 1e-6, c)
    g1 = torch.exp(torch.lgamma(1.0 + c))
    g2 = torch.exp(torch.lgamma(1.0 + 2.0 * c))
    g3 = torch.exp(torch.lgamma(1.0 + 3.0 * c))
    a = (1.0 - g1) / c
    var = (g2 - g1 * g1) / (c * c)
    ez3 = (1.0 - 3.0 * g1 + 3.0 * g2 - g3) / (c**3)
    central3 = ez3 - 3.0 * a * var - a**3
    return central3 / torch.clamp(var, min=1e-300) ** 1.5


def gev_fit_mm(x, *, n_iter: int = 80):
    """Batched method-of-moments GEV fit of x [..., N] (NaN padded).

    Solves the exact moment system: the skewness pins the shape (``n_iter``
    bisection steps on the decreasing :func:`_gev_skew` over (-1/3, 10)),
    then scale and location follow in closed form, the vectorized
    counterpart of scipy ``genextreme.fit(method="MM")``.  The moments are
    summed in x's dtype; the shape, scale and location are solved in
    float64, as the JAX package's 64-bit mode promotes them (in float32 the
    gamma functions' cancellations in the skewness would move the shape by
    ~1e-4), and returned in x's dtype.  Returns ``(c, loc, scale)``; rows
    with fewer than 3 valid values give NaN.
    """
    x = as_tensor(x)
    valid = ~torch.isnan(x)
    n = valid.sum(dim=-1)
    nf = torch.clamp(n, min=1).to(x.dtype)
    m = torch.where(valid, x, 0.0).sum(dim=-1) / nf
    d = torch.where(valid, x - m[..., None], 0.0)
    v = (d * d).sum(dim=-1) / nf  # biased, as scipy's raw-moment matching
    m3 = (d**3).sum(dim=-1) / nf
    g = (m3 / torch.clamp(v, min=1e-300) ** 1.5).double()
    lo = torch.full_like(g, -1.0 / 3.0 + 1e-4)
    hi = torch.full_like(g, 10.0)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        too_low = _gev_skew(mid) > g  # the skewness decreases: the shape must grow
        lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
    c = 0.5 * (lo + hi)
    cs = torch.where(c.abs() < 1e-6, 1e-6, c)
    g1 = torch.exp(torch.lgamma(1.0 + cs))
    g2 = torch.exp(torch.lgamma(1.0 + 2.0 * cs))
    var1 = (g2 - g1 * g1) / (cs * cs)
    scale = torch.sqrt(v / torch.clamp(var1, min=1e-300))
    loc = m - scale * (1.0 - g1) / cs
    bad = n < 3
    return tuple(torch.where(bad, torch.nan, a).to(x.dtype) for a in (c, loc, scale))


# ---------------------------------------------------------------------------
# the regularized incomplete beta function
# ---------------------------------------------------------------------------


def betainc(a, b, x):
    """Regularized incomplete beta function I_x(a, b), elementwise over
    broadcast tensors (``scipy.special.betainc``; PyTorch has none).

    The continued fraction of DLMF 8.17.22 by the modified Lentz method (the
    algorithm and constants of ``jax.scipy.special.betainc``), where it
    converges fast: at x < (a + 1) / (a + b + 2), else for I_{1-x}(b, a)
    through the symmetry 8.17.4.  It runs a fixed number of steps on every
    value, 200 in float32 and 600 in float64 (the JAX function's limits;
    it stops once every value has converged, which would need a host round
    trip a step); extra steps leave a converged value as it is.
    NaN for a, b < 0, x outside [0, 1] or a NaN argument.
    """
    a, b, x = torch.broadcast_tensors(*(as_tensor(t) for t in (a, b, x)))
    dtype = x.dtype
    n_iter = 200 if dtype == torch.float32 else 600
    finfo = torch.finfo(dtype)
    small = finfo.eps / 2
    a_zero = (a == 0) | (b == torch.inf)
    b_zero = (b == 0) | (a == torch.inf)
    result_zero = (b_zero & (x != 1)) | (a_zero & (x == 0))
    result_one = (a_zero & (x != 0)) | (b_zero & (x == 1))
    result_nan = (a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_zero & b_zero) | torch.isnan(a) | torch.isnan(b) | torch.isnan(x)

    fast = x < (a + 1) / (a + b + 2.0)
    a, b, x = torch.where(fast, a, b), torch.where(fast, b, a), torch.where(fast, x, 1 - x)
    one = torch.ones_like(x)
    # Lentz's recurrence: the first partial denominator is 0 (h, c = small),
    # every later one is 1; the first partial numerator is 1
    h = torch.full_like(x, small)
    cf, df = h, torch.zeros_like(x)
    zero_num = -(a + b) * x / (a + 1)
    for it in range(1, n_iter + 1):
        if it == 1:
            num = one
        else:
            m = (it - 1) // 2
            if it % 2 == 0:
                num = zero_num if m == 0 else -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1))
            else:
                num = m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))
        cf = 1.0 + num / cf
        cf = torch.where(cf.abs() < small, small, cf)
        df = 1.0 + num * df
        df = 1.0 / torch.where(df.abs() < small, small, df)
        h = h * (cf * df)

    very_small = finfo.tiny * 2
    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta = torch.lgamma(a) + lbeta_small_a
    factor = torch.where(
        a < very_small,
        torch.exp(torch.log1p(-x) * b - lbeta_small_a),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta) / a,
    )
    out = h * factor
    out = torch.where(fast, out, 1 - out)
    out = torch.where(result_zero, 0.0, out)
    out = torch.where(result_one, 1.0, out)
    return torch.where(result_nan, torch.nan, out)


# ---------------------------------------------------------------------------
# batched linear regression (the diagnostics: trend over many sites)
# ---------------------------------------------------------------------------

_LINREGRESS_FIELDS = ("slope", "intercept", "rvalue", "pvalue", "stderr", "intercept_stderr")


def linregress_field(y, x, field: str = "slope"):
    """Vectorized ``scipy.stats.linregress`` over the last axis of y [..., P]
    against x (broadcastable to y); NaNs in either are left out pairwise.

    ``field`` in {slope, intercept, rvalue, pvalue, stderr,
    intercept_stderr}; rows with fewer than 3 valid points, or a constant x,
    give NaN (reference ``properties.py:1189-1255``).
    """
    if field not in _LINREGRESS_FIELDS:
        raise ValueError(f"Unknown linregress field {field!r}")
    y = as_tensor(y)
    x = as_tensor(x, dtype=y.dtype, device=y.device).expand_as(y)
    m = ~torch.isnan(y) & ~torch.isnan(x)
    n = m.sum(dim=-1)
    nf = torch.clamp(n, min=1).to(y.dtype)
    xbar = torch.where(m, x, 0.0).sum(dim=-1) / nf
    ybar = torch.where(m, y, 0.0).sum(dim=-1) / nf
    dx = torch.where(m, x - xbar[..., None], 0.0)
    dy = torch.where(m, y - ybar[..., None], 0.0)
    ssxm = (dx * dx).sum(dim=-1) / nf
    ssym = (dy * dy).sum(dim=-1) / nf
    ssxym = (dx * dy).sum(dim=-1) / nf
    ssxm_s = torch.where(ssxm == 0, 1.0, ssxm)
    slope = ssxym / ssxm_s
    denom = ssxm * ssym
    r = torch.where(denom > 0, ssxym / torch.sqrt(torch.where(denom > 0, denom, 1.0)), 0.0)
    r = torch.clamp(r, -1.0, 1.0)
    df = (n - 2).to(y.dtype)
    if field == "slope":
        out = slope
    elif field == "intercept":
        out = ybar - slope * xbar
    elif field == "rvalue":
        out = r
    elif field == "pvalue":
        # 2 sf(|t|, df) for t = r sqrt(df / (1 - r^2)) equals I_{df/(df+t^2)}(df/2, 1/2)
        tiny = 1e-20
        t2 = r * r * df / ((1.0 - r + tiny) * (1.0 + r + tiny))
        out = betainc(df / 2.0, torch.full_like(df, 0.5), df / (df + t2))
    else:
        out = torch.sqrt((1.0 - r * r) * ssym / ssxm_s / torch.clamp(df, min=1.0))
        if field == "intercept_stderr":
            out = out * torch.sqrt(ssxm + xbar * xbar)
    out = torch.where(ssxm == 0, torch.nan, out)
    return torch.where(n < 3, torch.nan, out)


# ---------------------------------------------------------------------------
# host-side generic fitting (the diagnostics layer), numpy and scipy
# ---------------------------------------------------------------------------


def _threshold_loc_estimate(x_sorted):
    """Cooke (1979) lower-bound estimator from the smallest two and largest
    order statistics; used by the reference's gamma and fisk APP starts
    (``utils.py:1245-1285``).  Falls back to just below the minimum when the
    geometric condition degenerates."""
    x1, x2, xn = x_sorted[0], x_sorted[1], x_sorted[-1]
    denom = x1 + xn - 2 * x2
    loc0 = (x1 * xn - x2**2) / denom if denom != 0 else np.inf
    if not loc0 < x1:
        loc0 = 0.9999 * x1 if x1 > 0 else 1.0001 * x1
    return loc0


def _fit_start(x, dist_name: str, **fitkwargs):
    """The reference's starting values (``utils.py:1197-1296``), which
    double as the APP ("approximate") fit: the Gumbel-moment start for the
    GEV, Extremes.jl's moment start for the GPD with a known location,
    Cooke's threshold and Thom's shape for gamma, the moment-matched
    log-logistic for fisk, and the moment/plotting start for weibull_min."""
    x = np.asarray(x)
    x = x[~np.isnan(x)]
    m, v = x.mean(), x.var()
    if dist_name == "genextreme":
        s = np.sqrt(6 * v) / np.pi
        return (0.1,), {"loc": m - 0.57722 * s, "scale": s}
    if dist_name == "genpareto" and "floc" in fitkwargs:
        xs = x - fitkwargs["floc"]
        mxs, vxs = xs.mean(), xs.var()
        c0 = 0.5 * (1 - mxs**2 / vxs)
        return (c0,), {"scale": (1 - c0) * mxs}
    if dist_name == "gamma":
        loc0 = fitkwargs["floc"] if "floc" in fitkwargs else _threshold_loc_estimate(np.sort(x))
        xp = x - loc0
        xp = xp[xp > 0]
        mp = xp.mean()
        # Thom (1958) closed-form ML approximation for the shape
        A = np.log(mp) - np.log(xp).mean()
        a0 = (1 + np.sqrt(1 + 4 * A / 3)) / (4 * A)
        return (a0,), {"loc": loc0, "scale": mp / a0}
    if dist_name == "weibull_min":
        s = x.std()
        loc0 = x.min() - 0.01 * s
        # Gumbel-moment shape of log(x - loc), then moment scale
        c0 = np.pi / np.sqrt(6) / np.log(x - loc0).std()
        scale0 = ((x - loc0) ** c0).mean() ** (1 / c0)
        return (c0,), {"loc": loc0, "scale": scale0}
    if dist_name == "fisk":
        loc0 = fitkwargs["floc"] if "floc" in fitkwargs else _threshold_loc_estimate(np.sort(x))
        xp = x - loc0
        xp = xp[xp > 0]
        # moment matching of the two-parameter log-logistic
        m1, m2 = xp.mean(), (xp**2).mean()
        scale0 = 2 * m1**3 / (m2 + m1**2)
        c0 = np.pi * m1 / np.sqrt(3) / np.sqrt(m2 - m1**2)
        return (c0,), {"loc": loc0, "scale": scale0}
    return (), {}


# Closed-form inversions of the first three L-moments, after Hosking &
# Wallis, "Regional Frequency Analysis" (1997), App. A: the formulas the
# reference reaches through ``lmoments3`` (``utils.py:1178-1179``), in scipy
# conventions.

#: scipy distribution names with an L-moment estimator (the lmoments3 set)
PWM_SUPPORTED = ("expon", "gamma", "genextreme", "genpareto", "gumbel_r", "pearson3", "weibull_min")


def sample_lmoments(x):
    """First three unbiased sample L-moments ``(l1, l2, l3)`` of 1-D data
    through probability-weighted moments (Hosking 1990)."""
    x = np.sort(np.asarray(x, dtype=np.float64))
    n = x.size
    if n < 3:
        return np.nan, np.nan, np.nan
    j = np.arange(n, dtype=np.float64)  # rank - 1
    b0 = x.mean()
    b1 = np.sum(x * j) / (n * (n - 1.0))
    b2 = np.sum(x * j * (j - 1.0)) / (n * (n - 1.0) * (n - 2.0))
    return b0, 2 * b1 - b0, 6 * b2 - 6 * b1 + b0


def _gev_from_lmoments(l1, l2, t3):
    """GEV (k, loc, scale), scipy ``genextreme`` convention, from L-moments
    (Hosking's rational approximation for the shape)."""
    from scipy.special import gamma as _gamma

    z = 2.0 / (3.0 + t3) - np.log(2.0) / np.log(3.0)
    k = 7.8590 * z + 2.9554 * z * z
    if abs(k) < 1e-8:
        scale = l2 / np.log(2.0)
        return 0.0, l1 - _EULER * scale, scale
    g1 = _gamma(1.0 + k)
    scale = l2 * k / ((1.0 - 2.0 ** (-k)) * g1)
    return k, l1 - scale * (1.0 - g1) / k, scale


def _lmom_fit(x, name: str):
    """Parameter tuple for ``name`` from the sample L-moments of ``x``; NaNs
    when the L-moment ratios leave the distribution's feasible set (where
    lmoments3 raises)."""
    from scipy.special import gamma as _gamma

    if name not in PWM_SUPPORTED:
        raise NotImplementedError(
            f"PWM (L-moment) fitting is not implemented for {name!r}; supported distributions: {', '.join(PWM_SUPPORTED)}."
        )
    l1, l2, l3 = sample_lmoments(x)
    nan2, nan3 = (np.nan, np.nan), (np.nan, np.nan, np.nan)
    if not np.isfinite(l2) or l2 <= 0:
        return nan2 if name in ("expon", "gumbel_r") else nan3
    t3 = l3 / l2
    if name == "expon":
        scale = 2.0 * l2
        return (l1 - scale, scale)
    if name == "gumbel_r":
        scale = l2 / np.log(2.0)
        return (l1 - _EULER * scale, scale)
    if name == "genextreme":
        return nan3 if abs(t3) >= 1 else _gev_from_lmoments(l1, l2, t3)
    if name == "genpareto":
        if abs(t3) >= 1:
            return nan3
        k = (1.0 - 3.0 * t3) / (1.0 + t3)
        return (-k, l1 - (2.0 + k) * l2, (1.0 + k) * (2.0 + k) * l2)  # scipy c = -k (Hosking)
    if name == "gamma":
        if l1 <= l2:  # positive data with an L-CV under 1
            return nan3
        t = l2 / l1
        if t < 0.5:
            z = np.pi * t * t
            a = (1.0 - 0.3080 * z) / (z - 0.05812 * z * z + 0.01765 * z**3)
        else:
            z = 1.0 - t
            a = (0.7213 * z - 0.5947 * z * z) / (1.0 - 2.1817 * z + 1.2113 * z * z)
        return (a, 0.0, l1 / a)
    if name == "pearson3":
        at3 = abs(t3)
        if at3 >= 1:
            return nan3
        if at3 < 1e-8:  # the normal limit
            return (0.0, l1, l2 * np.sqrt(np.pi))
        if at3 < 1.0 / 3.0:
            z = 3.0 * np.pi * t3 * t3
            a = (1.0 + 0.2906 * z) / (z + 0.1882 * z * z + 0.0442 * z**3)
        else:
            z = 1.0 - at3
            a = (0.36067 * z - 0.59567 * z * z + 0.25361 * z**3) / (1.0 - 2.78861 * z + 2.56096 * z * z - 0.77045 * z**3)
        sigma = l2 * np.sqrt(np.pi * a) * _gamma(a) / _gamma(a + 0.5)
        return (2.0 / np.sqrt(a) * np.sign(t3), l1, sigma)
    # weibull_min: Weibull(delta, zeta, beta) <=> -X ~ GEV(k=1/delta,
    # xi=-zeta-beta, alpha=beta/delta), a GEV fit to the reflected L-moments
    if abs(t3) >= 1:
        return nan3
    k, xi, alpha = _gev_from_lmoments(-l1, l2, -t3)
    if not (k > 0):
        return nan3
    return (1.0 / k, -xi - alpha / k, alpha / k)


def fit_scipy(x, dist, method: str = "ML", **fitkwargs):
    """Fit a scipy distribution to 1-D data on the host (reference
    ``utils.py:1164-1193``).

    ``method`` in {"ML", "MM", "PWM", "APP"}.  Returns the parameter tuple in
    scipy order (shapes..., loc, scale).  PWM inverts the sample L-moments
    for the distributions lmoments3 supports (:data:`PWM_SUPPORTED`) and
    raises ``NotImplementedError`` otherwise; APP returns the reference's
    closed-form starting values as the fit.  A tensor is copied to the host.
    """
    from scipy import stats

    x = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, dtype=np.float64)
    x = x[~np.isnan(x)]
    if isinstance(dist, str):
        dist = getattr(stats, dist)
    name = dist.name
    if method == "PWM" and name not in PWM_SUPPORTED:
        _lmom_fit(x, name)  # raises NotImplementedError
    if len(x) <= 1:  # reference utils.py:1169-1171
        nparams = len(dist.shapes.split(",")) if dist.shapes else 0
        return tuple([np.nan] * (nparams + 2))
    if method == "ML":
        args, guess = _fit_start(x, name, **fitkwargs)
        try:
            params = dist.fit(x, *args, **guess, **fitkwargs)
        except Exception:  # scipy's optimizer refused the start: fit from its own
            params = dist.fit(x, **fitkwargs)
    elif method == "PWM":
        params = _lmom_fit(x, name)
    elif method == "MM":
        params = dist.fit(x, method="MM", **fitkwargs)
    elif method == "APP":
        args, guess = _fit_start(x, name, **fitkwargs)
        if "scale" not in guess:
            raise ValueError(
                f"The APP (approximate) fit has no starting estimator for {name!r}; "
                "supported: genextreme, genpareto (with floc), gamma, weibull_min, fisk."
            )
        params = (*args, guess.get("loc", 0.0), guess["scale"])
    else:
        raise ValueError(f"Unknown fitting method {method!r}")
    params = np.asarray(params, dtype=np.float64)
    # reference _fitfunc_1d: any NaN parameter poisons the whole vector
    if np.isnan(params).any():
        params[:] = np.nan
    return tuple(params)
