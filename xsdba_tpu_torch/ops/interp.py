"""Quantile-table lookup: the adjust-time hot path.

Replaces the reference's ``interp_on_quantiles`` (``utils.py:317-513``):

- ungrouped: per-slice ``scipy.interp1d`` with constant/NaN extrapolation from
  the first/last *non-NaN* table entries (``utils.py:350-377``);
- grouped: 2-D ``scipy.griddata`` over (value, fractional group index) with
  cyclic group padding + numba constant extrapolation
  (``utils.py:380-400``, ``nbutils.py:397-416``).

The plain form locates each value by summed comparisons over the (small,
static) quantile axis and selects the bracketing nodes by masked
accumulation (:func:`_interp_unrolled`).  The grouped lookup has three
routes (:func:`lookup_route`), chosen by shape, dtype and device alone.  Linear
and nearest, constant-extrapolated f32 tables of at most 64 nodes go to the
hand-written kernels of ``ops/cuda/interp_kernel.py``: on a CUDA tensor with blended
brackets and a site's padded tables within the kernel's shared-memory budget
(monthly and seasonal groups) one *bracketed* launch looks each value up in
its two bracketing groups' tables and blends; otherwise (collapsed brackets,
dayofyear's 367 tables a site, every CPU tensor) the lookup runs on static
bracket *partitions* of the time axis, every partition row evaluated against
its own table by the 3-D lookup (its kernel on a CUDA tensor, its plain twin
on a CPU tensor).  Everything else evaluates the partitions plainly.

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

from ..utils.grouper import partition_by_group
from ..utils.tensor import _check_leading, as_tensor, numpy_dtype, to_numpy, upload
from .cuda.fma_kernel import fma
from .cuda.interp_kernel import MAX_NQ as KERNEL_MAX_NQ
from .cuda.interp_kernel import METHODS as KERNEL_METHODS
from .cuda.interp_kernel import bracketed_fits, interp_bracketed, interp_table_2d, interp_table_3d

__all__ = [
    "bracket_steps",
    "interp1d_table",
    "interp_grouped_partitioned",
    "interp_on_quantiles_grouped",
    "interp_on_quantiles_reference",
    "lookup_route",
    "searchsorted_batched",
]

_UNROLL_MAX_NQ = 64


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


def _cubic_slopes(xs, ys, nvalid):
    """Not-a-knot cubic-spline slopes at the first ``nvalid`` compacted nodes.

    The tridiagonal system of scipy ``CubicSpline`` / ``interp1d(kind=
    "cubic")``: interior rows ``dx_i s_{i-1} + 2(dx_{i-1}+dx_i) s_i +
    dx_{i-1} s_{i+1} = 3(dx_i m_{i-1} + dx_{i-1} m_i)`` and the two
    not-a-knot boundary rows, built on the first ``nvalid`` nodes only (rows
    past ``nvalid`` are identity; the last boundary row sits at ``nvalid -
    1``), solved by Thomas elimination, a Python loop over the node axis
    batched over the leading dims (JAX package: ``ops/interp.py``
    ``_cubic_slopes``, a ``lax.scan``).  Rows with ``nvalid < 4`` (the
    caller degrades them to linear) and duplicated nodes (NaN slopes
    through the division) are where scipy raises.

    Every ``x * y + z`` that the JAX package's compiled programs contract
    is rounded once here too (:func:`fma`), with the product XLA's CPU
    backend fuses inside a compiled lookup (found by trying each; equal
    under ``==`` in float32 and float64): the first product of the interior
    and last rows' right-hand sides, the second of the first row's, the
    elimination's ``bk - ak * cp`` and ``rk - ak * rp`` and the back
    substitution's ``rp - cp * s``.  (``_cubic_slopes`` compiled alone
    fuses the last row's second product instead.)

    xs, ys: [..., n] compacted (+inf x pads); nvalid: [...].  Returns
    s [..., n] (unused past ``nvalid``).  Tables narrower than 3 columns
    raise a ``ValueError`` before the solve, the exception class the JAX
    package's lookup raises for them (its boundary rows do not broadcast).
    """
    n = xs.shape[-1]
    if n < 3:
        raise ValueError(
            f"cubic interpolation needs tables of at least 3 nodes, got {n}: train with nquantiles >= 3 or adjust with interp='linear'"
        )
    m = nvalid[..., None].long()                                    # [..., 1]
    xsf = torch.where(torch.isfinite(xs), xs, 0.0)
    valid_seg = torch.arange(n - 1, device=xs.device) < (m - 1)      # [..., n-1]
    dx = torch.where(valid_seg, xsf[..., 1:] - xsf[..., :-1], 1.0)
    sl = torch.where(valid_seg, (ys[..., 1:] - ys[..., :-1]) / dx, 0.0)
    dx, sl = torch.broadcast_tensors(dx, sl)

    def seg_at(a, idx):
        return torch.gather(a, -1, torch.clamp(idx, 0, n - 2))

    def node_at(a, idx):
        return torch.gather(a, -1, torch.clamp(idx, 0, n - 1).expand(a.shape[:-1] + (1,)))

    # interior coefficients, aligned so index i holds dx_{i-1} / dx_i
    one_seg = torch.ones_like(dx[..., :1])
    dx_im1 = torch.cat([one_seg, dx], dim=-1)
    dx_i = torch.cat([dx, one_seg], dim=-1)
    sl_im1 = torch.cat([torch.zeros_like(one_seg), sl], dim=-1)
    sl_i = torch.cat([sl, torch.zeros_like(one_seg)], dim=-1)
    a = dx_i
    b = 2.0 * (dx_im1 + dx_i)
    c = dx_im1
    r = 3.0 * fma(dx_i, sl_im1, dx_im1 * sl_i)

    # first boundary row (index 0): not-a-knot start
    dx0, dx1 = dx[..., 0:1], dx[..., 1:2]
    d0 = xsf[..., 2:3] - xsf[..., 0:1]
    r_first = fma(dx0 * dx0, sl[..., 1:2], (dx0 + 2.0 * d0) * dx1 * sl[..., 0:1]) / torch.where(d0 != 0, d0, 1.0)
    # last boundary row (index nvalid - 1): not-a-knot end
    m = m.expand(dx.shape[:-1] + (1,))
    dxm2, dxm3 = seg_at(dx, m - 2), seg_at(dx, m - 3)
    slm2, slm3 = seg_at(sl, m - 2), seg_at(sl, m - 3)
    d2 = node_at(xsf, m - 1) - node_at(xsf, m - 3)
    r_last = fma(dxm2 * dxm2, slm3, (2.0 * d2 + dxm2) * dxm3 * slm2) / torch.where(d2 != 0, d2, 1.0)

    ii = torch.arange(n, device=xs.device)
    is0, is_last, is_pad = ii == 0, ii == (m - 1), ii >= m
    a = torch.where(is_pad, 0.0, torch.where(is_last, d2, torch.where(is0, 0.0, a)))
    b = torch.where(is_pad, 1.0, torch.where(is_last, dxm3, torch.where(is0, dx1, b)))
    c = torch.where(is_pad | is_last, 0.0, torch.where(is0, d0, c))
    r = torch.where(is_pad, 0.0, torch.where(is_last, r_last, torch.where(is0, r_first, r)))

    # Thomas: forward elimination, then back substitution
    a, b, c, r = torch.broadcast_tensors(a, b, c, r)
    cps, rps = [], []
    cp = rp = torch.zeros_like(a[..., 0])
    for k in range(n):
        ak = a[..., k]
        denom = fma(-ak, cp, b[..., k])
        denom = torch.where(denom == 0, torch.nan, denom)
        cp, rp = c[..., k] / denom, fma(-ak, rp, r[..., k]) / denom
        cps.append(cp)
        rps.append(rp)
    s = [None] * n
    s_next = torch.zeros_like(cp)
    for k in range(n - 1, -1, -1):
        s_next = s[k] = fma(-cps[k], s_next, rps[k])
    return torch.stack(s, dim=-1)


def _eval_cubic_segment(v, x0, x1, y0, y1, s0, s1, lin):
    """Hermite evaluation of one cubic segment from its end slopes (scipy
    ``_cubic.py``'s coefficient form), its nested products rounded once as
    the JAX package's compiled adjust rounds them, and ``tc / hs`` as XLA
    rewrites it, ``(s0 + s1 - 2 mseg) / (hs * hs)``; ``lin`` where the
    segment is degenerate (``h == 0`` never happens on a valid table:
    duplicated nodes already carry NaN slopes)."""
    h = x1 - x0
    hs = torch.where(h > 0, h, 1.0)
    mseg = (y1 - y0) / hs
    curv = s0 + s1 - 2.0 * mseg
    tc = curv / hs
    dlt = v - x0
    inner = fma(dlt, curv / (hs * hs), (mseg - s0) / hs - tc)
    cub = fma(dlt, fma(dlt, inner, s0), y0)
    return torch.where(h > 0, cub, lin)


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


def _blend(v, x0, x1, y0, y1, method: str, cubic=None):
    """The value in the segment [x0, x1] → [y0, y1]: ``cubic`` is (s0, s1,
    nvalid), the segment's end slopes and the table's valid count."""
    # a single-valid-pair table pairs y0 with the NaN pad slot: t is 0
    # there, but 0 * (NaN - y0) would still poison the blend
    y1 = torch.where(torch.isnan(y1), y0, y1)
    dx = x1 - x0
    t = torch.where(dx > 0, (v - x0) / torch.where(dx == 0, 1, dx), 0.0)
    t = torch.where(torch.isfinite(t), t, 0.0)
    if method == "nearest":
        return torch.where(torch.abs(v - x0) <= torch.abs(x1 - v), y0, y1)
    if method not in ("linear", "cubic"):
        raise NotImplementedError(f"method={method!r}")
    # y0 + t * (y1 - y0), fused as the JAX package's compiled adjust fuses it
    lin = fma(t, y1 - y0, y0)
    if method == "linear":
        return lin
    s0, s1, nvalid = cubic
    out = _eval_cubic_segment(v, x0, x1, y0, y1, s0, s1, lin)
    # scipy raises below 4 nodes; the lookup degrades to linear there
    return torch.where(nvalid[..., None] < 4, lin, out)


def _interp_unrolled(v, xs, ys, nvalid, method: str, extrap: str):
    """Evaluate the compacted table (xs, ys, nvalid) at v.

    v: [..., T]; xs/ys: [..., nq] (leading dims broadcastable); nvalid [...].
    The nq axis is unrolled: count = sum_k (xs_k <= v) locates the segment,
    masked accumulation selects the bounds.  Above ``_UNROLL_MAX_NQ`` entries
    a binary-search + gather variant with identical semantics takes over.
    This is also the plain twin of the CUDA lookup kernel.  Every cubic
    lookup takes the gathered form, which reads the table a fixed number of
    times whatever nq is.
    """
    nq = xs.shape[-1]
    if nq > _UNROLL_MAX_NQ or method == "cubic":
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
    + gather bound selection.  The same semantics, bit for bit; used above
    ``_UNROLL_MAX_NQ`` nodes and for every cubic lookup."""
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
    cubic = None
    if method == "cubic":
        sp = _cubic_slopes(xs, ys, nvalid)
        s0 = take(sp, k0)
        cubic = (s0, torch.where(at_end, s0, take(sp, k1)), nvalid)
    out = _blend(v, x0, x1, y0, y1, method, cubic)
    return _finish(out, v, xs, ys, x_last, y_last, nvalid, extrap)


def interp1d_table(v, xq, yq, method: str = "linear", extrap: str = "constant"):
    """Evaluate the monotone table (xq, yq) at points v, batched.

    v: [..., T]; xq, yq: [..., nq] (leading dims broadcastable with v's).
    NaN pairs in the table are ignored; NaN in v stays NaN.
    ``extrap``: 'constant' fills beyond the table with the first/last valid
    yq; 'nan' fills with NaN (reference utils.py:353-368).
    ``method``: 'linear', 'nearest' or 'cubic' (the not-a-knot spline of
    scipy ``interp1d(kind="cubic")``; rows of fewer than 4 valid nodes
    degrade to linear where scipy raises).  Linear or nearest, with
    constant extrapolation, on float32 tables of at most
    ``KERNEL_MAX_NQ`` nodes goes through the 2-D lookup kernel's wrapper
    (``interp_table_2d``: the CUDA kernel on a CUDA tensor, its plain twin
    on a CPU tensor), one table per row of v's broadcast leading dims.
    """
    v = as_tensor(v)
    xq = as_tensor(xq, device=v.device)
    yq = as_tensor(yq, device=v.device)
    _check_leading(v.shape[:-1], xq.shape[:-1])
    xs, ys, nvalid = _compact_nan_pairs(xq, yq)
    if not _uses_kernel(v, xs, ys, method, extrap):
        return _interp_unrolled(v, xs, ys, nvalid, method, extrap)
    lead = torch.broadcast_shapes(v.shape[:-1], xs.shape[:-1])
    nq, L = xs.shape[-1], v.shape[-1]
    R = int(np.prod(lead, dtype=np.int64))
    rows = lambda a, *tail: a.expand(lead + tail).reshape((R,) + tail).contiguous()  # noqa: E731
    out = interp_table_2d(rows(v, L), rows(xs, nq), rows(ys, nq), rows(nvalid.to(torch.int32)), method)
    return out.reshape(lead + (L,))


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


def _served(device_type: str, dtype, nq: int, method: str, extrap: str) -> bool:
    """Whether the kernels' wrappers serve such a lookup: linear or nearest,
    constant extrapolation, float32 tables of at most ``KERNEL_MAX_NQ``
    nodes, on the CPU (their plain twins) or CUDA."""
    return (
        device_type in ("cpu", "cuda")
        and method in KERNEL_METHODS
        and extrap == "constant"
        and 0 < nq <= KERNEL_MAX_NQ
        and dtype == torch.float32
    )


def lookup_route(device_type: str, dtype, nq: int, gp: int, blended: bool, method: str, extrap: str) -> str:
    """The route of a lookup in ``gp`` (padded) tables of ``nq`` nodes a site,
    a function of shapes, dtype and device alone:

    - ``"plain"``: :func:`_interp_unrolled`; everything the kernels' wrappers
      do not serve (:func:`_served`);
    - ``"bracketed"``: one launch of the bracketed kernel, for a CUDA tensor
      with blended brackets whose tables fit its shared-memory budget
      (linear only: nearest never blends two groups);
    - ``"partition"``: the 3-D (or 2-D) lookup's wrapper on partition rows,
      which launches its kernel on a CUDA tensor and runs the kernel's plain
      twin on a CPU tensor.
    """
    if not _served(device_type, dtype, nq, method, extrap):
        return "plain"
    if device_type == "cuda" and blended and method == "linear" and bracketed_fits(gp, nq):
        return "bracketed"
    return "partition"


def _uses_kernel(vals, xqs, yqs, method: str, extrap: str) -> bool:
    """Whether the row lookups' wrappers serve these tensors."""
    return vals.dtype == xqs.dtype == yqs.dtype and _served(vals.device.type, vals.dtype, xqs.shape[-1], method, extrap)


def bracket_steps(g0, g1, w, device=None):
    """The per-time-step brackets as the bracketed kernel takes them: padded
    group ids ``g0``, ``g1`` [T] as contiguous int32 and the weight ``w`` [T]
    as contiguous float32, on ``device``."""
    step = lambda a, dtype: upload(a, dtype=dtype, device=device).contiguous()  # noqa: E731
    return step(g0, torch.int32), step(g1, torch.int32), step(w, torch.float32)


def _flat_tables(lead, xqs, yqs, nvs):
    """Tables xqs/yqs [..., Gs, nq] and counts nvs [..., Gs] broadcast to the
    leading dims ``lead`` and flattened to [B, Gs, nq] and int32 [B, Gs]."""
    Gs, nq = xqs.shape[-2:]
    B = int(np.prod(lead, dtype=np.int64))
    x3 = xqs.expand(lead + (Gs, nq)).reshape(B, Gs, nq).contiguous()
    y3 = yqs.expand(lead + (Gs, nq)).reshape(B, Gs, nq).contiguous()
    return x3, y3, nvs.expand(lead + (Gs,)).reshape(B, Gs).to(torch.int32).contiguous()


def _eval_tables(vals, xqs, yqs, nvs, method: str, extrap: str):
    """Evaluate partition rows vals [..., Gs, Lp] against their own tables
    xqs/yqs [..., Gs, nq] (nvs [..., Gs])."""
    if not _uses_kernel(vals, xqs, yqs, method, extrap):
        return _interp_unrolled(vals, xqs, yqs, nvs, method, extrap)
    x3, y3, n3 = _flat_tables(vals.shape[:-2], xqs, yqs, nvs)
    v3 = vals.reshape((x3.shape[0],) + vals.shape[-2:]).contiguous()
    return interp_table_3d(v3, x3, y3, n3, method).reshape(vals.shape)


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
    steps=None,
):
    """Grouped table lookup: each value in the tables of its time step's two
    bracketing padded groups, blended as ``fma(1 - w, val0, w * val1)``
    (rounded once, as the reference's compiled adjust rounds it).

    The caller has ``GroupIndexes.bracket_partitions``: the time axis is
    partitioned by bracketing padded group (``part0/part1`` [Gp, Lp],
    -1-padded), each partition row is evaluated against its *own* table in
    one batched call, and results scatter back through long-axis gathers.
    Work is 2·nq·T regardless of the group count.  ``part1`` None means
    collapsed brackets (nearest method / integer indexes): one partition, no
    blend.  On a CUDA tensor whose route is ``"bracketed"``
    (:func:`lookup_route`) the partitions are not used: one kernel launch
    takes ``g0``, ``g1`` and ``w`` [T] and does both lookups and the blend,
    reading ``v`` once.  ``steps`` is that triple ready for the kernel
    (:func:`bracket_steps` on ``v``'s device, as ``Brackets.steps`` keeps
    it); without it the three are converted on every call.

    ``tables_compact``: the tables are quantile-trained (ascending, NaN rows
    whole) — skip the argsort-based NaN compaction (bit-identical there;
    see :func:`_compact_sorted_tables`).
    """
    v = as_tensor(v)
    _check_leading(v.shape[:-1], np.shape(xq)[:-2])
    xq_p, yq_p, nv_p = _pad_cyclic_tables(as_tensor(xq, device=v.device), as_tensor(yq, device=v.device), tables_compact)
    T = v.shape[-1]
    Gp, nq = xq_p.shape[-2:]
    one_dtype = v.dtype == xq_p.dtype == yq_p.dtype
    if one_dtype and lookup_route(v.device.type, v.dtype, nq, Gp, part1 is not None, method, extrap) == "bracketed":
        x3, y3, n3 = _flat_tables(v.shape[:-1], xq_p, yq_p, nv_p)
        if steps is None or steps[0].device != v.device:
            steps = bracket_steps(g0, g1, w, v.device)
        return interp_bracketed(v.reshape(-1, T).contiguous(), x3, y3, n3, *steps).reshape(v.shape)

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
    return fma(1 - ww, val0, ww * val1)


def interp_on_quantiles_grouped(v, frac_idx, xq, yq, group_positions, method: str = "linear", extrap: str = "constant"):
    """Grouped quantile-table lookup with cyclic group blending.

    v: [..., T] values to look up; frac_idx: [T] fractional group index
    (1-based month/doy style — see ``Grouper.interp_index``);
    xq, yq: [..., G, nq] per-group tables; group_positions: [G] the group
    coordinate values (e.g. 1..12 for months).

    Equivalent of reference ``utils.py:409-513``: groups are cyclically padded
    (``add_cyclic_bounds``, utils.py:284-314) so indexes below the first /
    above the last group blend with the wrapped-around group.  For each
    timestep the two bracketing group tables are evaluated in 1-D and blended
    linearly by the fractional offset, ``(1 - w) * val0 + w * val1`` with
    every operation rounded (the JAX package accumulates the two products
    over a loop of the padded groups, where nothing contracts).  ``nearest``
    and a single group collapse the brackets onto one group.

    The brackets are a function of ``frac_idx`` and ``group_positions``
    alone, so they are computed on the host, in the data's dtype as the JAX
    package computes them, and the time axis is partitioned by bracketing
    group: every partition row is evaluated against its own table in one
    batched call (the 3-D lookup's wrapper where it serves the tensors, see
    :func:`lookup_route`), as :func:`interp_grouped_partitioned` does.
    """
    v = as_tensor(v)
    _check_leading(v.shape[:-1], np.shape(xq)[:-2])
    xq_p, yq_p, nv_p = _compact_nan_pairs(as_tensor(xq, device=v.device), as_tensor(yq, device=v.device))
    npdt = numpy_dtype(v.dtype)
    frac = to_numpy(frac_idx).astype(npdt)
    pos = to_numpy(group_positions).astype(npdt)
    G = xq_p.shape[-2]
    if G > 1:
        pos_p = np.concatenate([pos[:1] - (pos[1] - pos[0]), pos, pos[-1:] + (pos[-1] - pos[-2])])
        xq_p = torch.cat([xq_p[..., -1:, :], xq_p, xq_p[..., :1, :]], dim=-2)
        yq_p = torch.cat([yq_p[..., -1:, :], yq_p, yq_p[..., :1, :]], dim=-2)
        nv_p = torch.cat([nv_p[..., -1:], nv_p, nv_p[..., :1]], dim=-1)
    else:
        pos_p = pos
    Gp = xq_p.shape[-2]
    T = v.shape[-1]

    def eval_partition(grp):
        part, slot = partition_by_group(grp, Gp)
        pi = torch.as_tensor(part, device=v.device).long()
        vals = torch.where(pi >= 0, v[..., torch.clamp(pi, 0, max(T - 1, 0))], torch.nan)   # [..., Gp, Lp]
        out = _eval_tables(vals, xq_p, yq_p, nv_p, method, extrap)
        return out[..., torch.as_tensor(grp, device=v.device), torch.as_tensor(slot, device=v.device).long()]

    if Gp == 1:
        return eval_partition(np.zeros(T, dtype=np.int64))
    if method == "nearest" or G == 1:
        # single target group per timestep (both brackets collapse onto it)
        g = np.clip(np.searchsorted(pos_p, frac, side="left"), 1, Gp - 1)
        return eval_partition(np.where(frac - pos_p[g - 1] < pos_p[g] - frac, g - 1, g).astype(np.int64))
    g1 = np.clip(np.searchsorted(pos_p, frac, side="right"), 1, Gp - 1).astype(np.int64)
    g0 = g1 - 1
    p0, p1 = pos_p[g0], pos_p[g1]
    w = np.where(p1 > p0, (frac - p0) / np.where(p1 == p0, 1, p1 - p0), 0).astype(npdt)
    ww = torch.as_tensor(w, device=v.device)
    return (1 - ww) * eval_partition(g0) + ww * eval_partition(g1)


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
