"""Principal-component transform construction (reference ``utils.py:649-785``).

A NaN-tolerant covariance and its eigendecomposition, and the 2^M
orientation searches, batched over group blocks (the 2^M candidates are
one batched product, not a Python loop).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import as_tensor
from .rank import average_rank

__all__ = ["best_pc_orientation_full", "best_pc_orientation_simple", "first_eof_pattern", "pc_matrix", "pc_transform_matrix"]


def pc_matrix(arr):
    """arr [..., M, P] -> PC matrix [..., M, M]: the covariance's
    eigenvectors times the square roots of their eigenvalues, columns in
    descending order of the eigenvalues (as a Hermitian SVD orders them;
    each column's sign is arbitrary).

    Points (columns) with any NaN coordinate are left out (reference
    adjustment.py:1148-1153 drops them before ``np.cov``, ddof=1).
    """
    x = as_tensor(arr)
    valid = ~torch.isnan(x).any(dim=-2, keepdim=True)                  # [..., 1, P]
    n = valid.sum(dim=-1, keepdim=True).to(x.dtype)                      # [..., 1, 1]
    mean = torch.where(valid, x, 0.0).sum(dim=-1, keepdim=True) / torch.clamp(n, min=1)
    xc = torch.where(valid, x - mean, 0.0)
    cov = (xc @ xc.transpose(-1, -2)) / torch.clamp(n - 1, min=1)
    w, v = torch.linalg.eigh(cov)
    s = w.abs()
    # descending |eigenvalue|, equal ones in reverse index order: a stable
    # ascending sort reversed
    order = torch.sort(s, dim=-1, stable=True).indices.flip(-1)
    s = torch.gather(s, -1, order)
    u = torch.gather(v, -1, order[..., None, :].expand_as(v))
    return u * torch.sqrt(s)[..., None, :]


def _sign_vectors(m: int) -> np.ndarray:
    """All 2^m sign vectors, ordered like ``itertools.product([1, -1], repeat=m)``."""
    i = np.arange(2**m)[:, None]
    bit = (i >> (m - 1 - np.arange(m))[None, :]) % 2
    return np.where(bit == 0, 1.0, -1.0)


def _candidates(R, Hinv):
    """(S [K, M], S_k R H⁻¹ [K, ..., M, M]): every column orientation of R."""
    m = R.shape[-1]
    S = torch.as_tensor(_sign_vectors(m), dtype=R.dtype, device=R.device)
    S_b = S.reshape((S.shape[0],) + (1,) * (R.ndim - 2) + (1, m))
    return S, (S_b * R) @ Hinv


def best_pc_orientation_simple(R, Hinv, val: float = 1000.0):
    """Orientation minimizing the reprojection error of a far test point
    (reference utils.py:685-726).  R/Hinv: [..., M, M] -> [..., M]."""
    m = R.shape[-1]
    S, RH = _candidates(R, Hinv)
    P = val * torch.eye(m, dtype=R.dtype, device=R.device)
    err = torch.linalg.matrix_norm(P - RH @ P)                       # [K, ...]
    return S[torch.argmin(err, dim=0)]


def _corr(a, b):
    va = ~torch.isnan(a) & ~torch.isnan(b)
    n = torch.clamp(va.sum(dim=-1), min=1).to(a.dtype)
    ma = torch.where(va, a, 0.0).sum(dim=-1) / n
    mb = torch.where(va, b, 0.0).sum(dim=-1) / n
    ac = torch.where(va, a - ma[..., None], 0.0)
    bc = torch.where(va, b - mb[..., None], 0.0)
    return (ac * bc).sum(dim=-1) / torch.sqrt((ac * ac).sum(dim=-1) * (bc * bc).sum(dim=-1))


def best_pc_orientation_full(R, Hinv, Rmean, Hmean, hist):
    """Orientation maximizing the mean per-variable Spearman correlation of
    the candidate scenario with hist (reference utils.py:730-785).

    R/Hinv [..., M, M]; Rmean/Hmean [..., M]; hist [..., M, P] (NaN padded).
    """
    S, T = _candidates(R, Hinv)
    centred = hist - Hmean[..., None]
    scen = Rmean[..., None] + T @ torch.where(torch.isnan(centred), 0.0, centred)
    scen = torch.where(torch.isnan(hist), torch.nan, scen)
    score = _corr(average_rank(hist, axis=-1), average_rank(scen, axis=-1)).mean(dim=-1)   # [K, ...]
    return S[torch.argmax(score, dim=0)]


def first_eof_pattern(anom):
    """Leading EOF of an anomaly matrix ``anom`` [..., T, S].

    NaN entries are missing and add zero anomaly to the covariance
    products; sites with no finite entry come back NaN.  Returns
    ``(eof [..., S], var_frac [...])``, the EOF of unit L2 norm and signed
    so that its largest-magnitude loading is positive.  The eigenproblem is
    solved on the smaller Gram side (time by time when ``T <= S``, the
    leading vector mapped back through ``Aᵀu``).
    """
    anom = as_tensor(anom)
    T, S = anom.shape[-2:]
    finite = torch.isfinite(anom)
    site_ok = finite.any(dim=-2)
    a0 = torch.where(finite, anom, 0.0)
    if T <= S:
        w, u = torch.linalg.eigh(a0 @ a0.transpose(-1, -2))
        v = (a0.transpose(-1, -2) @ u[..., :, -1:])[..., 0]
    else:
        w, u = torch.linalg.eigh(a0.transpose(-1, -2) @ a0)
        v = u[..., :, -1]
    nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    v = v / torch.where(nrm == 0, 1.0, nrm)
    sgn = torch.sign(torch.gather(v, -1, v.abs().argmax(dim=-1, keepdim=True)))
    v = v * torch.where(sgn == 0, 1.0, sgn)
    tot = torch.where(w > 0, w, 0.0).sum(dim=-1)                     # PSD: guard rounding negatives
    return torch.where(site_ok, v, torch.nan), w[..., -1] / torch.where(tot == 0, 1.0, tot)


def pc_transform_matrix(ref, hist, *, best_orientation: str = "simple"):
    """Per-block transform ``T = (R · orient) H⁻¹`` and the centroids
    (reference adjustment.py:1144-1196).

    ref/hist [..., M, P] -> (trans [..., M, M], ref_mean, hist_mean [..., M]).
    """
    if best_orientation not in ("simple", "full"):
        raise ValueError(f"Unknown `best_orientation` method: {best_orientation}.")
    ref, hist = as_tensor(ref), as_tensor(hist)
    R = pc_matrix(ref)
    Hinv = torch.linalg.inv(pc_matrix(hist))
    ref_mean = torch.nanmean(ref, dim=-1)
    hist_mean = torch.nanmean(hist, dim=-1)
    if best_orientation == "simple":
        orient = best_pc_orientation_simple(R, Hinv)
    else:
        orient = best_pc_orientation_full(R, Hinv, ref_mean, hist_mean, hist)
    return (R * orient[..., None, :]) @ Hinv, ref_mean, hist_mean
