"""Quantile-table lookup: the adjust-time hot path.

Replaces the reference's ``interp_on_quantiles`` (``utils.py:317-513``):

- ungrouped: per-slice ``scipy.interp1d`` with constant/NaN extrapolation from
  the first/last *non-NaN* table entries (``utils.py:350-377``);
- grouped: 2-D ``scipy.griddata`` over (value, fractional group index) with
  cyclic group padding + numba constant extrapolation
  (``utils.py:380-400``, ``nbutils.py:397-416``).

The plain form locates each value by summed comparisons over the (small,
static) quantile axis and selects the bracketing nodes by masked
accumulation (:func:`_interp_unrolled`).  The grouped lookup runs on static
bracket partitions of the time axis: every partition row is evaluated against
its own table, and on a CUDA tensor (linear, constant extrapolation, f32,
nq <= 64) that evaluation is the hand-written kernel of
``ops/cuda/interp_kernel.py``.

The grouped case is *separable*: evaluate the 1-D interpolant of the two
groups bracketing each timestep's cyclic fractional index and blend linearly
— the structured equivalent of griddata's triangulation on this
quasi-regular grid (documented deviation: identical on the regular interior,
smoother near group boundaries).  ``mode="reference"`` callers use the exact
host scipy form, :func:`interp_on_quantiles_reference`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensor import as_tensor
from .cuda.interp_kernel import MAX_NQ as KERNEL_MAX_NQ
from .cuda.interp_kernel import interp_table_3d

__all__ = [
    "interp1d_table",
    "interp_grouped_partitioned",
    "interp_on_quantiles_reference",
    "searchsorted_batched",
]

_UNROLL_MAX_NQ = 64


def _cubic_unported(method: str):
    if method == "cubic":
        raise NotImplementedError(
            "interp='cubic' is not ported to xsdba_tpu_torch yet (ROADMAP A7); use 'linear' or 'nearest'."
        )


def searchsorted_batched(sorted_x, v, side: str = "right"):
    """Batched searchsorted over the last axis: for each value, the count of
    table entries ``<= v`` (``side="right"``) or ``< v`` (``"left"``)."""
    batch = torch.broadcast_shapes(sorted_x.shape[:-1], v.shape[:-1])
    sx = sorted_x.expand(batch + sorted_x.shape[-1:]).contiguous()
    vv = v.expand(batch + v.shape[-1:]).contiguous()
    return torch.searchsorted(sx, vv, right=side == "right")


def _compact_nan_pairs(xq, yq):
    """Drop (x, y) pairs where either is NaN by sorting them to the end.

    Matches the reference's mask ``isnan(oldx)|isnan(oldy)`` (utils.py:351).
    xq is assumed ascending (quantile tables); the compaction keeps order.
    Returns (xs, ys, nvalid) with invalid xs set to +inf.
    """
    bad = torch.isnan(xq) | torch.isnan(yq)
    key = torch.where(bad, torch.inf, xq)
    order = torch.argsort(key, dim=-1, stable=True)
    xs = torch.gather(key, -1, order)
    ys = torch.gather(yq.expand_as(key), -1, order)
    nvalid = (~bad).sum(dim=-1)
    return xs, ys, nvalid


def _finish(out, v, xs, ys, x_last, y_last, nvalid, extrap: str):
    """Extrapolation, empty-table and NaN-value rules shared by both forms."""
    below = v < xs[..., :1]
    above = v > x_last
    if extrap == "constant":
        out = torch.where(below, ys[..., :1], out)
        out = torch.where(above, y_last, out)
    elif extrap == "nan":
        out = torch.where(below | above, torch.nan, out)
    else:
        raise ValueError(f"extrapolation must be 'constant' or 'nan', got {extrap!r}")
    out = torch.where(nvalid[..., None] == 0, torch.nan, out)
    return torch.where(torch.isnan(v), torch.nan, out)


def _blend(v, x0, x1, y0, y1, method: str):
    # a single-valid-pair table pairs y0 with the NaN pad slot: t is 0
    # there, but 0 * (NaN - y0) would still poison the blend
    y1 = torch.where(torch.isnan(y1), y0, y1)
    dx = x1 - x0
    t = torch.where(dx > 0, (v - x0) / torch.where(dx == 0, 1, dx), 0.0)
    t = torch.where(torch.isfinite(t), t, 0.0)
    if method == "linear":
        return y0 + t * (y1 - y0)
    if method == "nearest":
        return torch.where(torch.abs(v - x0) <= torch.abs(x1 - v), y0, y1)
    _cubic_unported(method)
    raise NotImplementedError(f"method={method!r}")


def _interp_unrolled(v, xs, ys, nvalid, method: str, extrap: str):
    """Evaluate the compacted table (xs, ys, nvalid) at v.

    v: [..., T]; xs/ys: [..., nq] (leading dims broadcastable); nvalid [...].
    The nq axis is unrolled: count = sum_k (xs_k <= v) locates the segment,
    masked accumulation selects the bounds.  Above ``_UNROLL_MAX_NQ`` entries
    a binary-search + gather variant with identical semantics takes over.
    This is also the plain twin of the CUDA lookup kernel.
    """
    _cubic_unported(method)
    nq = xs.shape[-1]
    if nq > _UNROLL_MAX_NQ:
        return _interp_gathered(v, xs, ys, nvalid, method, extrap)
    last = torch.clamp(nvalid - 1, 0, nq - 1)[..., None]

    shape = torch.broadcast_shapes(v.shape, xs.shape[:-1] + (1,))
    cnt = torch.zeros(shape, dtype=torch.int32, device=v.device)
    for k in range(nq):
        cnt = cnt + (xs[..., k : k + 1] <= v)
    k0 = torch.minimum(torch.clamp(cnt - 1, min=0), torch.clamp(nvalid - 2, min=0)[..., None])

    x0 = torch.zeros(shape, dtype=v.dtype, device=v.device)
    x1 = torch.zeros_like(x0)
    y0 = torch.zeros_like(x0)
    y1 = torch.zeros_like(x0)
    x_last = torch.zeros_like(x0)
    y_last = torch.zeros_like(x0)
    for k in range(nq):
        xk = xs[..., k : k + 1]
        yk = ys[..., k : k + 1]
        m0 = k0 == k
        x0 = torch.where(m0, xk, x0)
        y0 = torch.where(m0, yk, y0)
        if k < nq - 1:
            x1 = torch.where(m0, xs[..., k + 1 : k + 2], x1)
            y1 = torch.where(m0, ys[..., k + 1 : k + 2], y1)
        else:
            x1 = torch.where(m0, torch.inf, x1)
            y1 = torch.where(m0, yk, y1)
        ml = last == k
        x_last = torch.where(ml, xk, x_last)
        y_last = torch.where(ml, yk, y_last)

    out = _blend(v, x0, x1, y0, y1, method)
    return _finish(out, v, xs, ys, x_last, y_last, nvalid, extrap)


def _interp_gathered(v, xs, ys, nvalid, method: str, extrap: str):
    """Large-table form of :func:`_interp_unrolled` — binary-search locate
    + gather bound selection.  The same semantics; used above
    ``_UNROLL_MAX_NQ`` nodes."""
    _cubic_unported(method)
    nq = xs.shape[-1]
    cnt = searchsorted_batched(xs, v, side="right")
    # a NaN value lands anywhere; its output is NaN whatever it selects
    k0 = torch.minimum(torch.clamp(cnt - 1, min=0), torch.clamp(nvalid - 2, min=0)[..., None])

    def take(a, idx):
        aa = a.expand(torch.broadcast_shapes(a.shape, idx.shape[:-1] + a.shape[-1:]))
        return torch.gather(aa, -1, idx)

    x0 = take(xs, k0)
    y0 = take(ys, k0)
    k1 = torch.clamp(k0 + 1, 0, nq - 1)
    at_end = k0 == nq - 1
    x1 = torch.where(at_end, torch.inf, take(xs, k1))
    y1 = torch.where(at_end, y0, take(ys, k1))
    last = torch.clamp(nvalid - 1, 0, nq - 1)[..., None] * torch.ones_like(k0)
    x_last = take(xs, last)
    y_last = take(ys, last)
    out = _blend(v, x0, x1, y0, y1, method)
    return _finish(out, v, xs, ys, x_last, y_last, nvalid, extrap)


def interp1d_table(v, xq, yq, method: str = "linear", extrap: str = "constant"):
    """Evaluate the monotone table (xq, yq) at points v, batched.

    v: [..., T]; xq, yq: [..., nq] (leading dims broadcastable with v's).
    NaN pairs in the table are ignored; NaN in v stays NaN.
    ``extrap``: 'constant' fills beyond the table with the first/last valid
    yq; 'nan' fills with NaN (reference utils.py:353-368).
    ``method``: 'linear' or 'nearest' ('cubic' is ROADMAP A7).
    """
    v = as_tensor(v)
    xq = as_tensor(xq, device=v.device)
    yq = as_tensor(yq, device=v.device)
    xs, ys, nvalid = _compact_nan_pairs(xq, yq)
    return _interp_unrolled(v, xs, ys, nvalid, method, extrap)


def _compact_sorted_tables(xq, yq):
    """Compaction fast path for tables KNOWN to be ascending with NaN pairs
    only as whole rows (quantile-trained tables: type-7 quantiles at
    ascending q are non-decreasing, and a group is either fitted — all nq
    entries finite — or empty — all NaN).  Bit-identical to
    :func:`_compact_nan_pairs` on such tables (the stable argsort there is
    the identity permutation), without the argsort and its gathers."""
    bad = torch.isnan(xq) | torch.isnan(yq)
    xs = torch.where(bad, torch.inf, xq)
    ys = torch.where(bad, torch.nan, yq)
    return xs, ys, (~bad).sum(dim=-1)


def _pad_cyclic_tables(xq, yq, tables_compact: bool = False):
    """Compact NaN pairs and add the cyclic group padding (one group wrapped
    on each side; reference utils.py:284-314).  ``tables_compact`` asserts
    the quantile-trained table shape (see :func:`_compact_sorted_tables`)."""
    compact = _compact_sorted_tables if tables_compact else _compact_nan_pairs
    xq, yq, nvalid = compact(xq, yq)
    if xq.shape[-2] > 1:
        xq = torch.cat([xq[..., -1:, :], xq, xq[..., :1, :]], dim=-2)
        yq = torch.cat([yq[..., -1:, :], yq, yq[..., :1, :]], dim=-2)
        nvalid = torch.cat([nvalid[..., -1:], nvalid, nvalid[..., :1]], dim=-1)
    return xq, yq, nvalid


def _uses_kernel(vals, xqs, yqs, method: str, extrap: str) -> bool:
    """The lookup kernel's wrapper serves linear/constant f32 tables of at
    most ``KERNEL_MAX_NQ`` nodes: it launches the CUDA kernel on a CUDA
    tensor and runs the kernel's plain twin on a CPU tensor.  Everything else
    is plain."""
    return (
        vals.device.type in ("cpu", "cuda")
        and method == "linear"
        and extrap == "constant"
        and 0 < xqs.shape[-1] <= KERNEL_MAX_NQ
        and vals.dtype == xqs.dtype == yqs.dtype == torch.float32
    )


def _eval_tables(vals, xqs, yqs, nvs, method: str, extrap: str):
    """Evaluate partition rows vals [..., Gs, Lp] against their own tables
    xqs/yqs [..., Gs, nq] (nvs [..., Gs])."""
    nq = xqs.shape[-1]
    if not _uses_kernel(vals, xqs, yqs, method, extrap):
        return _interp_unrolled(vals, xqs, yqs, nvs, method, extrap)
    lead = vals.shape[:-2]
    Gs, Lp = vals.shape[-2:]
    B = int(np.prod(lead, dtype=np.int64))
    v3 = vals.reshape(B, Gs, Lp).contiguous()
    x3 = xqs.expand(lead + (Gs, nq)).reshape(B, Gs, nq).contiguous()
    y3 = yqs.expand(lead + (Gs, nq)).reshape(B, Gs, nq).contiguous()
    n3 = nvs.expand(lead + (Gs,)).reshape(B, Gs).to(torch.int32).contiguous()
    return interp_table_3d(v3, x3, y3, n3).reshape(vals.shape)


def interp_grouped_partitioned(
    v,
    xq,
    yq,
    part0,
    g0,
    slot0,
    part1,
    g1,
    slot1,
    w,
    method: str = "linear",
    extrap: str = "constant",
    tables_compact: bool = False,
):
    """Grouped table lookup via static bracketing partitions.

    The caller has ``GroupIndexes.bracket_partitions``: the time axis is
    partitioned by bracketing padded group (``part0/part1`` [Gp, Lp],
    -1-padded), each partition row is evaluated against its *own* table in
    one batched call,
    and results scatter back through long-axis gathers.  Work is 2·nq·T
    regardless of the group count.  ``part1`` None means collapsed brackets
    (nearest method / integer indexes): one partition, no blend.

    ``tables_compact``: the tables are quantile-trained (ascending, NaN rows
    whole) — skip the argsort-based NaN compaction (bit-identical there;
    see :func:`_compact_sorted_tables`).
    """
    v = as_tensor(v)
    xq_p, yq_p, nv_p = _pad_cyclic_tables(as_tensor(xq, device=v.device), as_tensor(yq, device=v.device), tables_compact)
    T = v.shape[-1]

    def eval_partition(part, grp, slot):
        pi = as_tensor(part, device=v.device).long()
        vals = torch.where(pi >= 0, v[..., torch.clamp(pi, 0, T - 1)], torch.nan)  # [..., Gp, Lp]
        out = _eval_tables(vals, xq_p, yq_p, nv_p, method, extrap)                  # [..., Gp, Lp]
        return out[..., as_tensor(grp, device=v.device).long(), as_tensor(slot, device=v.device).long()]

    val0 = eval_partition(part0, g0, slot0)
    if part1 is None:
        return val0
    val1 = eval_partition(part1, g1, slot1)
    ww = as_tensor(w, dtype=v.dtype, device=v.device)
    return (1 - ww) * val0 + ww * val1


# ---------------------------------------------------------------------------
# exact reference-parity grouped lookup (host; scipy griddata)
# ---------------------------------------------------------------------------


def _first_last_nonnull(a):
    """Per-row (first, last) non-NaN values of a [..., nq] array
    (reference ``nbutils.py:378-394``)."""
    a = np.asarray(a, dtype=np.float64)
    valid = ~np.isnan(a)
    anyv = valid.any(axis=-1)
    first_i = np.argmax(valid, axis=-1)
    last_i = a.shape[-1] - 1 - np.argmax(valid[..., ::-1], axis=-1)
    first = np.take_along_axis(a, first_i[..., None], axis=-1)[..., 0]
    last = np.take_along_axis(a, last_i[..., None], axis=-1)[..., 0]
    return (
        np.where(anyv, first, np.nan),
        np.where(anyv, last, np.nan),
    )


def interp_on_quantiles_reference(
    v,
    newg,
    xq,
    yq,
    group_positions,
    method: str = "linear",
    extrap: str = "constant",
):
    """Bit-faithful reimplementation of the reference's grouped
    ``interp_on_quantiles`` (``utils.py:380-400`` + ``nbutils.py:397-416``):
    cyclic-pad the group axis with extrapolated coordinates, drop NaN nodes,
    run ``scipy.interpolate.griddata`` over the scattered
    (value, group-index) points, then re-apply the constant/nan
    extrapolation outside each group's interpolated table span.

    Host numpy path — parity runs, not perf runs.  Shapes: ``v`` [..., T],
    ``newg`` [T] (fractional group index for linear/cubic, exact group
    coordinates for nearest), ``xq``/``yq`` [..., G, nq],
    ``group_positions`` [G].
    """
    v = np.asarray(v, dtype=np.float64)
    newg = np.asarray(newg, dtype=np.float64)
    xq = np.asarray(xq, dtype=np.float64)
    yq = np.asarray(yq, dtype=np.float64)
    pos = np.asarray(group_positions, dtype=np.float64)
    G = pos.shape[0]

    # reference add_cyclic_bounds(..., cyclic_coords=False): wrap the rows,
    # extrapolate the coordinate by its neighbouring step
    if G > 1:
        pos_p = np.concatenate([[2 * pos[0] - pos[1]], pos, [2 * pos[-1] - pos[-2]]])
    else:
        pos_p = np.concatenate([pos - 1.0, pos, pos + 1.0])
    xq_p = np.concatenate([xq[..., -1:, :], xq, xq[..., :1, :]], axis=-2)
    yq_p = np.concatenate([yq[..., -1:, :], yq, yq[..., :1, :]], axis=-2)

    batch = np.broadcast_shapes(v.shape[:-1], xq.shape[:-2], yq.shape[:-2])
    T = v.shape[-1]
    nq = xq.shape[-1]
    vf = np.broadcast_to(v, batch + (T,)).reshape(-1, T)
    xf = np.broadcast_to(xq_p, batch + (G + 2, nq)).reshape(-1, G + 2, nq)
    yf = np.broadcast_to(yq_p, batch + (G + 2, nq)).reshape(-1, G + 2, nq)
    oldg = np.broadcast_to(pos_p[:, None], (G + 2, nq))

    # when the tables carry no batch dims (e.g. QDM's shared quantile nodes)
    # every row interpolates over the SAME (value, group) point cloud —
    # triangulate once instead of once per row (Delaunay dominates griddata)
    shared = xq.ndim == 2 and yq.ndim == 2
    fn_shared = lo_x = hi_x = lo_y = hi_y = None
    if shared:
        mask_old = np.isnan(xq_p) | np.isnan(yq_p)
        if not mask_old.all():
            fn_shared = _griddata_interpolator(
                xq_p[~mask_old], oldg[~mask_old], yq_p[~mask_old], method
            )
            # extrapolation bounds depend only on the tables and newg: hoist
            blo, bhi = _first_last_nonnull(xq_p)
            lo_x = np.interp(newg, pos_p, blo)
            hi_x = np.interp(newg, pos_p, bhi)
            if extrap == "constant":
                clo, chi = _first_last_nonnull(yq_p)
                lo_y = np.interp(newg, pos_p, clo)
                hi_y = np.interp(newg, pos_p, chi)

    out = np.full_like(vf, np.nan)
    for b in range(vf.shape[0]):
        newx = vf[b]
        mask_new = np.isnan(newx) | np.isnan(newg)
        if mask_new.all():
            continue
        if shared:
            if fn_shared is None:
                continue
            fn = fn_shared
        else:
            oldx, oldy = xf[b], yf[b]
            mask_old = np.isnan(oldx) | np.isnan(oldy)
            if mask_old.all():
                continue
            fn = _griddata_interpolator(
                oldx[~mask_old], oldg[~mask_old], oldy[~mask_old], method
            )
        res = out[b]
        res[~mask_new] = fn(newx[~mask_new], newg[~mask_new])
        if method == "nearest" or extrap != "nan":
            # nbutils._extrapolate_on_quantiles: per-group table span,
            # linearly interpolated over the padded group coordinate
            if shared:
                toolow = newx < lo_x
                toohigh = newx > hi_x
            else:
                blo, bhi = _first_last_nonnull(oldx)
                lo_x = np.interp(newg, pos_p, blo)
                hi_x = np.interp(newg, pos_p, bhi)
                toolow = newx < lo_x
                toohigh = newx > hi_x
                if extrap == "constant":
                    clo, chi = _first_last_nonnull(oldy)
                    lo_y = np.interp(newg, pos_p, clo)
                    hi_y = np.interp(newg, pos_p, chi)
            if extrap == "constant":
                res[toolow] = lo_y[toolow]
                res[toohigh] = hi_y[toohigh]
            else:
                res[toolow] = np.nan
                res[toohigh] = np.nan
    return out.reshape(batch + (T,))


def _griddata_interpolator(px, pg, values, method: str):
    """The interpolator ``scipy.interpolate.griddata`` would build for the
    scattered 2-D points (px, pg) — constructed once so repeated evaluations
    share the Delaunay triangulation."""
    import scipy.interpolate as si

    pts = np.column_stack([px.ravel(), pg.ravel()])
    if method == "nearest":
        f = si.NearestNDInterpolator(pts, values.ravel())
    elif method == "linear":
        f = si.LinearNDInterpolator(pts, values.ravel(), fill_value=np.nan)
    elif method == "cubic":
        f = si.CloughTocher2DInterpolator(pts, values.ravel(), fill_value=np.nan)
    else:  # pragma: no cover - caller validates
        raise ValueError(f"Unknown griddata method {method!r}")
    return lambda qx, qg: f(np.column_stack([qx.ravel(), qg.ravel()])).ravel()
