"""OTC and dOTC: (dynamical) Optimal Transport Correction (Robin 2021).

Behavioural reference: ``adjustment.py:1394-1715``, ``_adjustment.py:1236-1680``
(histogram both datasets, solve an exact transport plan between the occupied
bins, send every source point to a target bin drawn from its bin's plan row,
optionally jitter it inside the bin; dOTC first transports the hist -> sim
evolution onto ref).

The transports are host work in float64 numpy, as in the JAX package: the
histograms, the exact plan solves (the port's own C++ network simplex,
``native.emd``) and the sampling run on the CPU whatever the data's device,
the groups' solves thread-parallel (the solver releases the GIL).  Only the
``sinkhorn`` solver computes its plan with PyTorch, on the data's device,
and the frequency adaptation of hist runs on the data's device too.  The
result comes back as a float64 tensor on the device of the data adjusted.

- The stochastic bin assignment is one vectorized inverse CDF over the
  plan's row CDFs (``_send_points``), not a loop over source bins.
- The uniforms come from the port's stream (``utils/rng.py``): each group
  takes a CPU generator seeded from the stream's CPU generator on the calling
  thread (:func:`_group_draws`), so a run on the card and a run on the CPU
  draw alike.  Parity tests replace :func:`_group_draws` to hand in the JAX
  package's Threefry draws (ROADMAP C4).
- The dOTC motion and rescale are vectorized over variables with a
  multiplicative-kind mask; the Cholesky rescale uses a triangular solve.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..ops.ot import bin_width_estimator, eps_cholesky, optimal_transport
from ..ops.segment import gather_groups, scatter_back
from ..utils.container import DataArray
from ..utils.grouper import Grouper
from ..utils.rng import next_generator
from ..utils.tensor import default_device, input_tensor, to_numpy
from ..utils.units import str2quantity
from .base import Adjust

__all__ = ["OTC", "dOTC"]

_MAX_PLAN_THREADS = 8


class _Support(NamedTuple):
    """Occupied-bin histogram support of a point cloud."""

    centers: np.ndarray  # [B, V] lattice centers of the occupied bins
    weights: np.ndarray  # [B] relative frequencies
    cell_of: np.ndarray  # [N] occupied-bin row of each point


def _support(pts: np.ndarray, width: np.ndarray, origin: np.ndarray) -> _Support:
    """Histogram ``pts`` [N, V] over the (width, origin) lattice, keeping only
    occupied cells (reference ``utils.py:1054-1071``), with the point -> cell
    map that the vectorized sampler needs."""
    cells = np.floor((pts - origin) / width)
    occ, cell_of, counts = np.unique(cells, axis=0, return_inverse=True, return_counts=True)
    return _Support((occ + 0.5) * width + origin, counts / counts.sum(), cell_of.ravel())


class _Draws:
    """Uniform variates in [0, 1), float64, from one CPU generator seeded
    with ``seed``; each group owns one, so group workers never share a
    generator."""

    def __init__(self, seed: int):
        self._gen = torch.Generator().manual_seed(seed)

    def uniform(self, *shape: int) -> np.ndarray:
        return torch.rand(shape, dtype=torch.float64, generator=self._gen).numpy()


def _group_draws(n_groups: int) -> list:
    """One :class:`_Draws` a group, seeded from the stream's CPU generator
    (on the calling thread, in group order)."""
    gen = next_generator("cpu")
    seeds = torch.randint(0, 2**62, (n_groups,), generator=gen).tolist()
    return [_Draws(s) for s in seeds]


class _BinSpec(NamedTuple):
    """User bin configuration; ``None`` entries are estimated per transport
    from the participating clouds (Freedman-Diaconis, as the reference does
    when ``bin_width`` is not given)."""

    width: np.ndarray | None
    origin: np.ndarray | None

    def resolve(self, clouds: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        nvar = clouds[0].shape[1]
        width = bin_width_estimator(clouds) if self.width is None else self.width
        origin = np.zeros(nvar) if self.origin is None else self.origin
        return np.broadcast_to(width, (nvar,)).astype(float), np.broadcast_to(origin, (nvar,)).astype(float)

    def fill(self, clouds: list[np.ndarray]) -> "_BinSpec":
        """Estimate the NaN-marked width entries (dict form with unnamed
        variables) from the participating clouds, per group, as the
        reference does (``_adjustment.py:1285-1289`` estimates from that
        call's [Y, X]; dOTC fixes one estimate from [Y0, X0, X1] for its
        three internal transports, ``_adjustment.py:1486-1491``)."""
        if self.width is None or not np.isnan(self.width).any():
            return self
        est = bin_width_estimator(clouds)
        return self._replace(width=np.where(np.isnan(self.width), est, self.width))


def _parse_bin_arg(value, default, nvar: int, vnames: list[str]) -> np.ndarray | None:
    """Lower the public ``bin_width`` / ``bin_origin`` argument (scalar,
    array, or per-variable dict; reference ``_adjustment.py:1360-1388``) to a
    [V] vector, or None when it must be estimated from the data."""
    if value is None:
        return None
    if isinstance(value, dict):
        out = default.copy()
        for k, v in value.items():
            out[vnames.index(k) if isinstance(k, str) else k] = v
        return out
    if np.isscalar(value):
        return np.full(nvar, float(value))
    return np.asarray(value, dtype=float)


def _send_points(X, Y, spec: _BinSpec, draws, *, num_iter_max: int, normalization: str, solver: str, jitter: bool, device) -> np.ndarray:
    """Map the rows of ``X`` [N, V] onto the distribution of ``Y`` [M, V].

    Every source point inherits the plan row of its histogram cell (a
    categorical over target cells) and picks a target by inverting that
    row's CDF at one uniform.  The output is the target cell's lattice
    center, optionally jittered uniformly within the cell.
    """
    width, origin = spec.resolve([Y, X])
    src, tgt = _support(X, width, origin), _support(Y, width, origin)
    plan = optimal_transport(src.centers, tgt.centers, src.weights, tgt.weights, num_iter_max, normalization, solver, device=device)
    row_cdf = np.cumsum(plan, axis=1)[src.cell_of]  # [N, Bt]
    # u in (0, total]: scaling into the row total guards rows not summing
    # exactly to 1, and the open lower bound keeps a u == 0 draw from
    # selecting a zero-probability leading bin
    u = (1.0 - draws.uniform(len(X))) * row_cdf[:, -1]
    picked = np.minimum((row_cdf < u[:, None]).sum(axis=1), row_cdf.shape[1] - 1)
    mapped = tgt.centers[picked]
    if jitter:
        mapped = mapped + (draws.uniform(*mapped.shape) - 0.5) * width
    return mapped


def _finite_rows(a: np.ndarray) -> np.ndarray:
    return np.isfinite(a).all(axis=1)


def _otc_group(X, Y, spec, draws, *, num_iter_max, normalization, solver, jitter, device) -> np.ndarray:
    """One group's OTC: transport hist points ``X`` onto ref ``Y``, keeping
    NaN rows (window pads, missing data) in place."""
    keep_x, keep_y = _finite_rows(X), _finite_rows(Y)
    out = np.full_like(X, np.nan)
    if keep_x.any() and keep_y.any():
        out[keep_x] = _send_points(
            X[keep_x], Y[keep_y], spec.fill([Y[keep_y], X[keep_x]]), draws,
            num_iter_max=num_iter_max, normalization=normalization, solver=solver, jitter=jitter, device=device,
        )
    return out


def _dotc_group(X1, Y0, X0, spec, draws, *, num_iter_max, cov_factor, jitter, mult_mask, normalization, solver, device) -> np.ndarray:
    """One group's dOTC: the simulated evolution read at the ref points (ref
    pulled through hist, then sim), rescaled, displaces ref; the sim points
    are then transported onto the displaced ref."""
    keep = _finite_rows(X1)
    sim_f, ref_f, hist_f = X1[keep], Y0[_finite_rows(Y0)], X0[_finite_rows(X0)]
    out = np.full_like(X1, np.nan)
    if not (len(sim_f) and len(ref_f) and len(hist_f)):
        return out

    spec = spec.fill([ref_f, hist_f, sim_f])  # one estimate for all three transports
    common = dict(num_iter_max=num_iter_max, normalization=normalization, solver=solver, device=device)
    ref_at_hist = _send_points(ref_f, hist_f, spec, draws, jitter=False, **common)
    ref_at_sim = _send_points(ref_at_hist, sim_f, spec, draws, jitter=False, **common)

    motion = np.where(mult_mask, ref_at_sim / ref_at_hist, ref_at_sim - ref_at_hist)
    if cov_factor == "cholesky":
        L_ref = eps_cholesky(np.cov(ref_f, rowvar=False))
        L_hist = eps_cholesky(np.cov(hist_f, rowvar=False))
        # right-multiply by (L_ref @ L_hist^-1)^T without forming an inverse
        motion = motion @ np.linalg.solve(L_hist.T, L_ref.T)
    elif cov_factor == "std":
        motion = motion * (ref_f.std(axis=0) / hist_f.std(axis=0))

    displaced_ref = np.where(mult_mask, ref_f * motion, ref_f + motion)
    out[keep] = _send_points(sim_f, displaced_ref, spec, draws, jitter=jitter, **common)
    return out


def _host(da: DataArray, pts_dim: str) -> np.ndarray:
    """The data as a host array [V, T]."""
    dac = da.move_dim_last("time")
    return np.moveaxis(to_numpy(dac.data), dac.dims.index(pts_dim), 0)


def _grouped_PV(arr: np.ndarray, gi) -> list[np.ndarray]:
    """[V, T] -> one [P_g, V] matrix a group (P = windowed member count, NaN
    rows at window pads)."""
    out = []
    for g in range(gi.n_groups):
        idx = gi.gather_idx[g]
        vals = np.where(idx[None, :] >= 0, arr[:, np.clip(idx, 0, arr.shape[-1] - 1)], np.nan)
        out.append(vals.T)
    return out


def _device_of(da: DataArray) -> torch.device:
    """Where the result goes: a tensor's device, else the ``device`` option's."""
    return da.data.device if isinstance(da.data, torch.Tensor) else default_device()


def _run_groups(worker, n_groups: int):
    """Run the per-group transports thread-parallel (the plan solves
    dominate and release the GIL in the C++ solver)."""
    if n_groups == 1:
        return [worker(0)]
    with ThreadPoolExecutor(max_workers=min(_MAX_PLAN_THREADS, n_groups)) as pool:
        return list(pool.map(worker, range(n_groups)))


def _assemble(da_like: DataArray, gi, pts_dim: str, group_results, device) -> DataArray:
    """Scatter the per-group [P, V] results back onto the time axis (window
    centers only) and wrap them like ``da_like``, as a float64 tensor on
    ``device``."""
    dac = da_like.move_dim_last("time")
    ax = dac.dims.index(pts_dim)
    shape = list(dac.shape)
    out = np.full([shape[ax]] + shape[:ax] + shape[ax + 1 :], np.nan)  # [V, T]
    for g, Z in enumerate(group_results):
        members = np.flatnonzero(gi.group_idx == g)
        out[:, members] = Z[gi.scatter_slot[members]].T
    data = torch.as_tensor(np.moveaxis(out, 0, ax), device=device)
    res = DataArray(data, dac.dims, dict(dac.coords), dict(da_like.attrs), "scen")
    return res.transpose(*da_like.dims) if dac.dims != da_like.dims else res


def _spec(bin_width, bin_origin, nvar: int, vnames: list[str]) -> _BinSpec:
    return _BinSpec(
        _parse_bin_arg(bin_width, np.full(nvar, np.nan), nvar, vnames),
        _parse_bin_arg(bin_origin, np.zeros(nvar), nvar, vnames),
    )


class OTC(Adjust):
    r"""Optimal Transport Correction (Robin et al. 2021; reference
    adjustment.py:1394-1589).

    One-shot multivariate mapping of hist onto ref through the optimal
    transport plan between their histograms.  ``sim`` must be None (the
    adjusted series is the hist period).  The plan solves and the sampling
    are host work (module docstring).
    """

    _allow_diff_time_sizes = True

    @classmethod
    def _adjust(
        cls,
        ref: DataArray,
        hist: DataArray,
        sim: DataArray,
        *,
        bin_width=None,
        bin_origin=None,
        num_iter_max: int = 100_000_000,
        jitter_inside_bins: bool = True,
        adapt_freq_thresh: dict | None = None,
        normalization: str = "max_distance",
        group: str | Grouper = "time",
        pts_dim: str = "multivar",
        solver: str = "emd",
    ):
        if not sim.attrs.pop("_is_hist", False):
            raise ValueError("OTC does not take a `sim` argument, the hist period is adjusted.")
        group = Grouper(group) if isinstance(group, str) else group
        vnames = [str(v) for v in np.asarray(ref.coords[pts_dim])]
        device = _device_of(hist)
        hist_arr = _apply_adapt_freq(adapt_freq_thresh, ref, hist, group, pts_dim, vnames)

        gi = group.indexes(hist.time)
        ref_blocks = _grouped_PV(_host(ref, pts_dim), group.indexes(ref.time))
        hist_blocks = _grouped_PV(hist_arr, gi)
        spec = _spec(bin_width, bin_origin, len(vnames), vnames)
        draws = _group_draws(gi.n_groups)

        def worker(g: int) -> np.ndarray:
            return _otc_group(
                hist_blocks[g], ref_blocks[g], spec, draws[g], num_iter_max=num_iter_max,
                normalization=normalization, solver=solver, jitter=jitter_inside_bins, device=device,
            )

        return _assemble(hist, gi, pts_dim, _run_groups(worker, gi.n_groups), device)


class dOTC(Adjust):
    r"""Dynamical OTC (reference adjustment.py:1591-1715): transports the
    hist -> sim evolution onto ref, preserving the simulated change.  The
    plan solves and the sampling are host work (module docstring)."""

    _allow_diff_time_sizes = True

    @classmethod
    def _adjust(
        cls,
        ref: DataArray,
        hist: DataArray,
        sim: DataArray,
        *,
        bin_width=None,
        bin_origin=None,
        num_iter_max: int = 100_000_000,
        cov_factor: str = "std",
        jitter_inside_bins: bool = True,
        kind: dict | None = None,
        adapt_freq_thresh: dict | None = None,
        normalization: str = "max_distance",
        group: str | Grouper = "time",
        pts_dim: str = "multivar",
        solver: str = "emd",
    ):
        group = Grouper(group) if isinstance(group, str) else group
        vnames = [str(v) for v in np.asarray(ref.coords[pts_dim])]
        device = _device_of(sim)
        hist_arr = _apply_adapt_freq(adapt_freq_thresh, ref, hist, group, pts_dim, vnames)
        mult_mask = np.zeros(len(vnames), dtype=bool)
        for k, v in (kind or {}).items():
            mult_mask[vnames.index(k) if isinstance(k, str) else k] = v == "*"

        gi = group.indexes(sim.time)
        ref_blocks = _grouped_PV(_host(ref, pts_dim), group.indexes(ref.time))
        hist_blocks = _grouped_PV(hist_arr, group.indexes(hist.time))
        sim_blocks = _grouped_PV(_host(sim, pts_dim), gi)
        spec = _spec(bin_width, bin_origin, len(vnames), vnames)
        draws = _group_draws(gi.n_groups)

        def worker(g: int) -> np.ndarray:
            return _dotc_group(
                sim_blocks[g], ref_blocks[g], hist_blocks[g], spec, draws[g], num_iter_max=num_iter_max,
                cov_factor=cov_factor, jitter=jitter_inside_bins, mult_mask=mult_mask,
                normalization=normalization, solver=solver, device=device,
            )

        return _assemble(sim, gi, pts_dim, _run_groups(worker, gi.n_groups), device)


def _apply_adapt_freq(adapt_freq_thresh, ref: DataArray, hist: DataArray, group: Grouper, pts_dim: str, vnames) -> np.ndarray:
    """hist [V, T] as a host array, each variable named in
    ``adapt_freq_thresh`` frequency-adapted to ref (reference
    ``_adjustment.py:1390-1394``) on the data's device."""
    from ..processing import _adapt_freq_grouped

    arr = _host(hist, pts_dim)
    if not adapt_freq_thresh:
        return arr
    arr = arr.copy()
    gi = group.indexes(hist.time)
    refarr, histarr = (
        torch.movedim(input_tensor(dac.data), dac.dims.index(pts_dim), 0) for dac in (ref.move_dim_last("time"), hist.move_dim_last("time"))
    )
    var_attrs = hist.attrs.get("_variable_attrs", {})
    for var, thresh in adapt_freq_thresh.items():
        iv = vnames.index(var)
        units = var_attrs.get(var, {}).get("units", "")
        th = str2quantity(thresh).to(units).magnitude if units else str2quantity(thresh).magnitude
        refg = gather_groups(refarr[iv].to(histarr.device), gi.gather_idx)
        histg = gather_groups(histarr[iv], gi.gather_idx)
        ad, *_ = _adapt_freq_grouped(refg, histg, th)
        arr[iv] = to_numpy(scatter_back(ad, gi.group_idx, gi.scatter_slot))
    return arr
