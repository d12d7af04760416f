"""Optimal-transport utilities (reference ``utils.py:1028-1146``).

Histogramming and plan construction for OTC / dOTC.  The histograms, the
costs and the exact plans are host work in float64 numpy, as in the JAX
package; two solvers:

- ``emd``: the port's own C++ exact solver (``xsdba_tpu_torch.native``, a
  network simplex), matching the reference's POT results; host code;
- ``sinkhorn``: entropic OT in PyTorch, in log space, on the device asked
  for; it converges to the exact plan as ``reg -> 0`` (a documented
  deviation when used).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import as_tensor, to_numpy

__all__ = [
    "bin_width_estimator",
    "eps_cholesky",
    "histogram",
    "optimal_transport",
    "sinkhorn_plan",
]


def bin_width_estimator(X):
    """Freedman-Diaconis with Scott's rule where the IQR is 0 (reference
    utils.py:1028-1052); a list takes the per-dimension minimum."""
    if isinstance(X, list):
        return np.min([bin_width_estimator(x) for x in X], axis=0)
    X = np.asarray(X)
    if X.ndim == 1:
        X = X.reshape(-1, 1)
    bw = 2.0 * (np.percentile(X, 75, axis=0) - np.percentile(X, 25, axis=0)) / np.power(X.shape[0], 1.0 / 3.0)
    return np.where(bw == 0, 3.49 * np.std(X, axis=0) / np.power(X.shape[0], 1.0 / 3.0), bw)


def histogram(data, bin_width, bin_origin):
    """Multidimensional histogram over the occupied bins only (reference
    utils.py:1054-1071).  Returns (bin centers, frequencies, the bin index
    row of each point)."""
    data = np.asarray(data)
    idx_bin = np.floor((data - bin_origin) / bin_width)
    grid, mu = np.unique(idx_bin, return_counts=True, axis=0)
    return (grid + 0.5) * bin_width + bin_origin, mu / mu.sum(), idx_bin


def sinkhorn_plan(mu, nu, cost, reg: float = 5e-3, n_iter: int = 500):
    """Entropic OT plan [n, m] by Sinkhorn iterations in log space, on the
    device of ``cost`` (a tensor keeps its device; numpy goes to the CPU)."""
    C = as_tensor(cost)
    mu, nu = as_tensor(mu, dtype=C.dtype, device=C.device), as_tensor(nu, dtype=C.dtype, device=C.device)
    C = C / torch.clamp(C.max(), min=1e-30)
    logmu = torch.log(torch.clamp(mu, min=1e-300))
    lognu = torch.log(torch.clamp(nu, min=1e-300))
    f, g = torch.zeros_like(mu), torch.zeros_like(nu)
    for _ in range(n_iter):
        f = reg * (logmu - torch.logsumexp((-C + g[None, :]) / reg, dim=1))
        g = reg * (lognu - torch.logsumexp((-C + f[:, None]) / reg, dim=0))
    return torch.exp((f[:, None] + g[None, :] - C) / reg)


def optimal_transport(gridX, gridY, muX, muY, num_iter_max=100_000_000, normalization="max_distance", solver="emd", device=None):
    """Row-normalized transport plan between histogram grids (reference
    utils.py:1074-1113): normalize the grids, squared Euclidean costs,
    solve, normalize the rows to conditional probabilities.  ``emd`` solves
    on the host; ``sinkhorn`` on ``device`` (the CPU by default)."""
    gridX = np.asarray(gridX, dtype=np.float64)
    gridY = np.asarray(gridY, dtype=np.float64)
    if normalization == "standardize":
        gridX = (gridX - gridX.mean(axis=0)) / gridX.std(axis=0)
        gridY = (gridY - gridY.mean(axis=0)) / gridY.std(axis=0)
    elif normalization == "max_distance":
        max1 = np.abs(gridX.max(axis=0) - gridY.min(axis=0))
        max2 = np.abs(gridY.max(axis=0) - gridX.min(axis=0))
        md = np.maximum(max1, max2)
        gridX = gridX / md
        gridY = gridY / md
    elif normalization == "max_value":
        mv = np.maximum(gridX.max(axis=0), gridY.max(axis=0))
        gridX = gridX / mv
        gridY = gridY / mv
    elif normalization is not None:
        raise ValueError(f"Unknown normalization {normalization!r}")

    diff = gridX[:, None, :] - gridY[None, :, :]
    C = np.einsum("ijk,ijk->ij", diff, diff)

    if solver == "emd":
        from ..native import emd

        gamma = emd(muX, muY, C)
    elif solver == "sinkhorn":
        gamma = to_numpy(sinkhorn_plan(muX, muY, torch.as_tensor(C, device=device)))
    else:
        raise ValueError(f"Unknown solver {solver!r}")
    rows = gamma.sum(axis=1, keepdims=True)
    return gamma / np.where(rows == 0, 1, rows)


def eps_cholesky(M, nit: int = 26):
    """Cholesky with a growing diagonal perturbation until positive-definite
    (reference utils.py:1116-1146)."""
    M = np.asarray(M, dtype=np.float64)
    try:
        return np.linalg.cholesky(M)
    except np.linalg.LinAlgError:
        pass
    eps = min(1e-9, float(np.abs(np.diagonal(M)).min())) or 1e-9
    for _ in range(nit):
        try:
            return np.linalg.cholesky(M + np.eye(M.shape[0]) * eps)
        except np.linalg.LinAlgError:
            eps *= 2
    raise ValueError("The vcov matrix is far from positive-definite. Please use `cov_factor = 'std'`")
