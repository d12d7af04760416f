"""NaN-aware batched quantiles.

Replaces the reference's numba kernels (``nbutils.py:24-271``): per-row sort +
type-7 (Hyndman-Fan; ``alpha=beta=1``) linear interpolation, NaN-aware.

One ``torch.sort`` over the reduced axis (NaNs sort last, like numpy), then a
vectorized gather + lerp — no Python-level row loop, any leading batch dims.
``torch.nanquantile`` is not used: its lerp is not the symmetric
:func:`_lerp` of the reference, so it differs in the last bits.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..utils.tensor import as_tensor

__all__ = [
    "grouped_nan_quantile",
    "nan_quantile",
    "vecquantiles",
    "windowed_group_quantile",
]


def _virtual_index(valid_count, quantiles, alpha: float, beta: float):
    # Reference nbutils.py:130: n*q + (alpha + q*(1-alpha-beta)) - 1
    return valid_count * quantiles + (alpha + quantiles * (1 - alpha - beta)) - 1


def _lerp(left, right, gamma):
    # Symmetric lerp for fp accuracy — mirrors nbutils.py:77-106.
    diff = right - left
    out = left + diff * gamma
    return torch.where(gamma >= 0.5, right - diff * (1 - gamma), out)


def _quantile_on_sorted(sorted_x, valid, quantiles, alpha, beta, sentinel: str = "nan"):
    """Type-7 quantiles given a pre-sorted (NaNs-last) last axis.

    sorted_x: [..., n]; valid: [...] count of non-NaN entries;
    quantiles: [..., nq] (broadcastable against leading dims).
    Returns [..., nq].

    ``sentinel="inf"`` marks padding beyond ``valid`` as +inf instead of NaN
    (the merged-row layout of ``ops/merge.py``); the out-of-range clip then
    catches +inf too, and rows with no valid value give NaN explicitly.
    """
    n = sorted_x.shape[-1]
    v = valid[..., None].to(sorted_x.dtype)
    # Bounds handling (nbutils.py:30-68): above valid-1 -> last element of the
    # *full* row (index -1, a NaN/+inf pad — later clipped to the max valid
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
    if sentinel == "inf":
        bad = torch.isnan(interp) | (interp == torch.inf)
        out = torch.where(bad, max_valid, interp)
        return torch.where(valid[..., None] == 0, torch.nan, out)
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


# ---------------------------------------------------------------------------
# Windowed grouped quantile: the merge engine (the doy+window hot path)
# ---------------------------------------------------------------------------


def _static_safe(*xs) -> bool:
    """True when the static extraction is value-safe for every ``x``: each
    site row is all finite or all NaN.  One host synchronisation.

    With all-finite rows every group's windowed valid count equals the
    plan's host-known member count, so the extraction indices are host
    constants; all-NaN rows (ocean-masked sites) are masked explicitly.
    Rows with a partial NaN pattern (or any +/-inf) take the exact
    dynamic-count path (reference ``ops/quantile.py:174-195``)."""
    ok = torch.ones((), dtype=torch.bool, device=xs[0].device)
    for x in xs:
        ok = ok & torch.all(torch.isfinite(x).all(dim=-1) | torch.isnan(x).all(dim=-1))
    return bool(ok)


def _static_ok(plan, quantiles) -> bool:
    """The plan knows its member counts and the quantiles are one shared row."""
    return plan.nv_host is not None and len(np.shape(quantiles)) == 1


def _static_extract_indices(counts, q_static, n, npdt, alpha, beta):
    """Host-side (numpy) replication of ``_virtual_index`` and the bounds
    handling of :func:`_quantile_on_sorted` for host-known valid counts:
    (prev idx, next idx, gamma, empty mask), each [G, nq] / [G].  The
    arithmetic is rounded in ``npdt`` op for op, as the reference does
    (``ops/quantile.py:205-227``), so the selected columns are exact."""
    nvh = np.asarray(counts, dtype=np.int64)[:, None]          # [G, 1]
    v = nvh.astype(npdt)
    qs = np.asarray(q_static, dtype=npdt)[None, :]             # [1, nq]
    vi = (v * qs + (npdt(alpha) + qs * npdt(1.0 - alpha - beta)) - npdt(1.0)).astype(npdt)
    prev = np.floor(vi)
    above = vi >= v - npdt(1.0)
    below = vi < 0
    pi = np.clip(prev, 0, n - 1).astype(np.int64)
    ni = np.clip(prev + 1, 0, n - 1).astype(np.int64)
    # above/below land on pad/first entries; the gather path's range clip
    # then substitutes the max valid value — statically that is nv-1
    last_valid = np.maximum(nvh - 1, 0)
    pi = np.where(above, last_valid, np.where(below, 0, pi))
    ni = np.where(above, last_valid, np.where(below, 0, ni))
    gamma = (vi - prev).astype(npdt)
    empty = nvh[:, 0] == 0
    return pi, ni, gamma, empty


def _static_flat_extract(merged, counts, q_static, alpha, beta):
    """Static-count extraction as one gather of host-computed indices from
    the flattened [..., G*n] merged rows, then the symmetric lerp
    (reference ``ops/quantile.py:230-257``)."""
    G, n = merged.shape[-2:]
    npdt = np.float32 if merged.dtype == torch.float32 else np.float64
    pi, ni, gamma, empty = _static_extract_indices(counts, q_static, n, npdt, alpha, beta)
    nq = pi.shape[1]
    lead = merged.shape[:-2]
    rowbase = np.arange(G, dtype=np.int64)[:, None] * n
    both = torch.as_tensor(np.concatenate([(rowbase + pi).ravel(), (rowbase + ni).ravel()]), device=merged.device)
    vals = merged.reshape(lead + (G * n,))[..., both]
    left = vals[..., : G * nq].reshape(lead + (G, nq))
    right = vals[..., G * nq :].reshape(lead + (G, nq))
    out = _lerp(left, right, torch.as_tensor(gamma, device=merged.device))
    if empty.any():
        out = torch.where(torch.as_tensor(empty, device=merged.device)[:, None], torch.nan, out)
    return out


_PLAN_DEVICE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _plan_device_arrays(plan, device):
    """A WindowMergePlan's index arrays (extended window-1 lists, edge ids,
    edge gather rows) on ``device``, cached per plan and device: plans are
    long-lived (cached on their TimeIndex), so their device copies are too."""
    per_plan = _PLAN_DEVICE_CACHE.setdefault(plan, {})
    key = torch.device(device)
    hit = per_plan.get(key)
    if hit is None:
        idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=key)  # noqa: E731
        hit = per_plan[key] = (idx(plan.w1_gather), idx(plan.edge_ids), idx(plan.edge_gather))
    return hit


def _windowed_slab(x, plan, w1):
    """The extended window-1 lists of ``x`` [..., T] as [..., G + 2*half,
    Ymax] rows (NaN pads), by a reshape and transpose on the regular layout
    (``plan.regular_period``: the wrap rows are year-dropped slices with a
    NaN pad) or by a gather."""
    if plan.regular_period is None:
        from .segment import gather_groups

        return gather_groups(x, w1)
    P, half = plan.regular_period, plan.half
    lead = x.shape[:-1]
    Y = x.shape[-1] // P
    core = x.reshape(lead + (Y, P)).transpose(-1, -2)                  # [..., P, Y]
    napad = torch.full(lead + (half, 1), torch.nan, dtype=x.dtype, device=x.device)
    head = torch.cat([core[..., P - half : P, : Y - 1], napad], dim=-1)
    tail = torch.cat([core[..., 0:half, 1:], napad], dim=-1)
    return torch.cat([head, core, tail], dim=-2)


def merge_slab(x, plan):
    """The merge engine's input for ``x`` [..., T]: (slab [B, Dp, m]
    unsorted, valid counts [..., Gx] of the extended window-1 lists, level
    count L).  Row r of the slab is extended list r of one site (+inf for
    NaN and pads, m = ``plan.ypad``); its Dp rows hold every group's window
    [g, g + window) and are a multiple of the largest level run (2^L rows,
    L = 0 below window 9, where no levels are built)."""
    from .merge import n_levels

    w1, _, _ = _plan_device_arrays(plan, x.device)
    Gx, Ymax = plan.w1_gather.shape
    G = Gx - 2 * plan.half
    B = int(np.prod(x.shape[:-1], dtype=np.int64))
    vals = _windowed_slab(x, plan, w1)                                  # [..., Gx, Ymax]
    missing = torch.isnan(vals)
    L = n_levels(plan.window) if plan.window >= 9 else 0
    align = max(2, 1 << L)
    dp = -(-max(Gx, G - 1 + plan.window) // align) * align
    slab = torch.full((B, dp, plan.ypad), torch.inf, dtype=x.dtype, device=x.device)
    slab[:, :Gx, :Ymax] = torch.where(missing, torch.inf, vals).reshape(B, Gx, Ymax)
    return slab, (~missing).sum(dim=-1), L


def _windowed_group_quantile_core(x, plan, quantiles, *, static: bool, alpha: float = 1.0, beta: float = 1.0):
    """One batch of the merge engine (reference ``ops/quantile.py:456-583``):
    slab of sorted window-1 lists -> merged window rows -> type-7 extraction,
    static (host-known counts) or dynamic; edge groups re-sorted exactly."""
    from .merge import build_levels, fold_windows, merged_window_rows, sort_rows_alternating

    Gx, Ymax = plan.w1_gather.shape
    half, window = plan.half, plan.window
    G = Gx - 2 * half
    slab, V, L = merge_slab(x, plan)
    slab = sort_rows_alternating(slab)
    if L:
        merged = fold_windows(slab, build_levels(slab, L), window, G, ymax=Ymax)
    else:
        merged = merged_window_rows(slab, window, G, ymax=Ymax)
    merged = merged.reshape(x.shape[:-1] + (G, merged.shape[-1]))

    q = as_tensor(quantiles, dtype=x.dtype, device=x.device)
    if static:
        q_static = np.asarray(quantiles.cpu() if isinstance(quantiles, torch.Tensor) else quantiles, np.float64)
        out = _static_flat_extract(merged, plan.nv_host, q_static, alpha, beta)
        # all-NaN site rows are static-safe only with an explicit mask: their
        # merged rows are all +inf, which the static indices would read
        out = torch.where(torch.isnan(x).all(dim=-1)[..., None, None], torch.nan, out)
    else:
        # sliding valid counts over the extended rows: nv[g] = sum V[g : g+window]
        Vp = torch.nn.functional.pad(V, (0, max(window - 2 * half, 0)))
        cs = torch.nn.functional.pad(torch.cumsum(Vp, dim=-1), (1, 0))
        idx = torch.arange(G, device=x.device)
        nv = cs[..., idx + window] - cs[..., idx]
        out = _quantile_on_sorted(merged, nv, q, alpha, beta, sentinel="inf")

    _, edge_ids, edge_gather = _plan_device_arrays(plan, x.device)
    if edge_ids.numel():
        from .segment import gather_groups

        out[..., edge_ids, :] = nan_quantile(gather_groups(x, edge_gather), q, axis=-1, alpha=alpha, beta=beta)
    return out


def _windowed_max_chunk(plan) -> int:
    """Sites per call that keep the merged intermediate [chunk, G, window *
    Ymax] near 2^30 values (~4 GB in f32), as the reference bounds it."""
    Gx, Ymax = plan.w1_gather.shape
    per_site = (Gx - 2 * plan.half) * plan.window * Ymax
    return max(1, (1 << 30) // max(per_site, 1))


def _windowed_chunks(x, plan, quantiles, *, static: bool, alpha: float = 1.0, beta: float = 1.0):
    """:func:`_windowed_group_quantile_core` over the flattened batch in
    chunks of at most :func:`_windowed_max_chunk` sites."""
    lead = x.shape[:-1]
    B = int(np.prod(lead, dtype=np.int64))
    chunk = _windowed_max_chunk(plan)
    core = lambda xc: _windowed_group_quantile_core(xc, plan, quantiles, static=static, alpha=alpha, beta=beta)  # noqa: E731
    if x.ndim <= 1 or B <= chunk:
        return core(x)
    xf = x.reshape(B, x.shape[-1])
    out = torch.cat([core(xf[i : i + chunk]) for i in range(0, B, chunk)], dim=0)
    return out.reshape(lead + out.shape[1:])


def windowed_group_quantile(x, plan, quantiles, alpha: float = 1.0, beta: float = 1.0):
    """Windowed grouped quantile through shared per-group sorts and merges.

    Selects the same order statistics as ``grouped_nan_quantile(x,
    gi.gather_idx, q)`` for windowed dayofyear / "5D" groupings (the same
    multiset per group, the same type-7 semantics), but sorts each window-1
    list once and merges ``window`` sorted lists per group
    (``ops/merge.py``) instead of re-sorting the window-fold amplified
    gather matrix.  Edge groups (year wrap, series ends) take the exact
    gather+sort path.  With all-finite (or all-NaN) site rows the type-7
    indices and gammas come from the plan's host-known counts, rounded in
    numpy op for op; in float32 that can differ from the re-sort oracle's
    device arithmetic by a few ulp in gamma (up to ~5e-7 relative in the
    value), with the same selected elements.

    x: [..., T]; ``plan`` a :class:`~xsdba_tpu_torch.utils.grouper.WindowMergePlan`
    (``GroupIndexes.merge_plan``); quantiles [nq].  Returns [..., G, nq].
    """
    x = as_tensor(x)
    static = _static_ok(plan, quantiles) and _static_safe(x)
    return _windowed_chunks(x, plan, quantiles, static=static, alpha=alpha, beta=beta)
