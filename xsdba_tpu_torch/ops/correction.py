"""Correction-factor arithmetic, ECDF utilities, and grouped-factor broadcast.

Reference semantics: ``utils.py:31-32,108-314`` (kinds, get/apply correction,
invert, ecdf, map_cdf, equally_spaced_nodes, broadcast with cyclic bounds).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import as_tensor

__all__ = [
    "ADDITIVE",
    "MULTIPLICATIVE",
    "apply_correction",
    "broadcast_group_factors",
    "ecdf",
    "equally_spaced_nodes",
    "get_correction",
    "invert",
    "map_cdf",
]

ADDITIVE = "+"
MULTIPLICATIVE = "*"


def get_correction(x, y, kind: str):
    """y - x (additive) or y / x (multiplicative) — reference utils.py:131-143."""
    if kind == ADDITIVE:
        return y - x
    if kind == MULTIPLICATIVE:
        return y / x
    raise ValueError("kind must be + or *.")


def apply_correction(x, factor, kind: str | None = None):
    """x + factor (additive) or x * factor (multiplicative) —
    reference utils.py:148-163.  When ``kind`` is None it is read from the
    factor's ``kind`` attribute (set by grouped trainers)."""
    if kind is None:
        kind = getattr(factor, "attrs", {}).get("kind")
    if kind == ADDITIVE:
        return x + factor
    if kind == MULTIPLICATIVE:
        return x * factor
    raise ValueError("kind must be + or *.")


def invert(x, kind: str | None = None):
    """-x (additive) or 1/x (multiplicative) — reference utils.py:166-177.
    When ``kind`` is None it is read from x's ``kind`` attribute."""
    if kind is None:
        kind = getattr(x, "attrs", {}).get("kind")
    if kind == ADDITIVE:
        return -x
    if kind == MULTIPLICATIVE:
        return 1 / x
    raise ValueError("kind must be + or *.")


def ecdf(x, value, axis: int = -1):
    """P(X <= value): reference utils.py:35-105 — NaN-aware empirical CDF."""
    x = as_tensor(x)
    value = as_tensor(value, device=x.device)
    le = torch.where(torch.isnan(x), False, x <= value.unsqueeze(axis)).sum(dim=axis)
    n = (~torch.isnan(x)).sum(dim=axis)
    return le.to(x.dtype) / n.to(x.dtype)


def map_cdf(x, y, y_value, axis: int = -1):
    """Return the value in x with the same empirical CDF as ``y_value`` in y
    (reference utils.py:66-105; used by LOCI threshold mapping)."""
    from .quantile import vecquantiles

    q = ecdf(y, y_value, axis=axis)
    return vecquantiles(x, q, axis=axis)


def equally_spaced_nodes(n: int, eps: float | None = None) -> np.ndarray:
    """n bin-midpoint quantile nodes in [0, 1] (reference utils.py:251-281)."""
    dq = 1 / n / 2
    q = np.linspace(dq, 1 - dq, n)
    if eps is None:
        return q
    return np.insert(np.append(q, 1 - eps), 0, eps)


def broadcast_group_factors(
    factors,
    frac_idx,
    group_idx,
    group_positions,
    interp: str = "nearest",
):
    """Map per-group factors [..., G] back onto the time axis [..., T].

    Reference ``utils.py:180-248``: nearest selection by group id, or linear
    interpolation over the fractional group index with cyclic padding
    (``add_cyclic_bounds``).
    """
    f = as_tensor(factors)
    gidx = as_tensor(group_idx, device=f.device).long()
    if interp == "nearest":
        return f[..., gidx]
    if interp != "linear":
        raise NotImplementedError(f"interp={interp!r}")
    pos = as_tensor(group_positions, dtype=f.dtype, device=f.device)
    frac = as_tensor(frac_idx, dtype=f.dtype, device=f.device)
    G = f.shape[-1]
    if G == 1:
        return f[..., torch.zeros_like(gidx)]
    step0 = pos[1] - pos[0]
    step1 = pos[-1] - pos[-2]
    pos_p = torch.cat([pos[:1] - step0, pos, pos[-1:] + step1])
    f_p = torch.cat([f[..., -1:], f, f[..., :1]], dim=-1)
    g1 = torch.clamp(torch.searchsorted(pos_p, frac, right=True), 1, pos_p.shape[0] - 1)
    g0 = g1 - 1
    w = (frac - pos_p[g0]) / (pos_p[g1] - pos_p[g0])
    return (1 - w) * f_p[..., g0] + w * f_p[..., g1]
