"""Exceedance clusters with static shapes.

Replaces the reference's run finding (``utils.py:788-921``: pad-and-diff
plus a Python loop over runs).  A run is a stretch of ``x > u2``; it is a
cluster when its maximum exceeds ``u1``.  Runs get ids by a cumulative sum
of their starts, each run's maximum comes from one ``scatter_reduce``
(``amax``) over (row, run id) and a gather back to its members; clusters get
ids by a cumulative sum over qualifying starts only, so the static bound
``max_clusters`` can be the reference's own over-allocation
``(1 - q_thresh) * T * 1.05`` (``adjustment.py:856``).  Clusters past the
bound are dropped, as the reference's fixed-size output drops them.  No
loop over rows and no host synchronisation.  Outputs are NaN / -1 padded
and compacted to the front in chronological order.
"""

from __future__ import annotations

import math

import torch

from ..utils.tensor import as_tensor

__all__ = ["cluster_fields", "cluster_maxima"]


def _starts(exce):
    prev = torch.cat([torch.zeros_like(exce[..., :1]), exce[..., :-1]], dim=-1)
    return exce & ~prev


def _segment(reduce: str, src, seg, n_seg: int, fill):
    """Per-row segment reduction of ``src`` [R, T] by ids ``seg`` [R, T] in
    [0, n_seg): [R, n_seg], ``fill`` where a segment is empty."""
    out = torch.full((src.shape[0], n_seg), fill, dtype=src.dtype, device=src.device)
    return out.scatter_reduce_(-1, seg, src, reduce, include_self=True)


def _cluster_maxima(x, u1, u2, C: int):
    """The clusters' members and maxima, rows flattened to R: (lead, qstart
    [..., T], qid [..., T] (a member's cluster id, 0 elsewhere), seg [R, T]
    (ids clamped to C + 1, non-members C + 1), member [R, T], mx [R, C + 2]
    (-inf where a slot is empty; slot 0 and C + 1 are not clusters))."""
    lead, T = x.shape[:-1], x.shape[-1]
    thr = lambda u: as_tensor(u, dtype=x.dtype, device=x.device)  # noqa: E731
    exce = ~torch.isnan(x) & (x > thr(u2))
    starts = _starts(exce)
    rid = torch.cumsum(starts, dim=-1) * exce
    vals = torch.where(exce, x, -torch.inf)
    R = math.prod(lead)
    flat = lambda a: a.expand(lead + (T,)).reshape(R, T)  # noqa: E731
    rid2, vals2 = flat(rid), flat(vals)
    rmax = torch.gather(_segment("amax", vals2, rid2, T + 1, -torch.inf), -1, rid2).reshape(lead + (T,))
    qualify = exce & (rmax > thr(u1))
    qstart = starts & qualify
    qid = torch.cumsum(qstart, dim=-1) * qualify

    seg = flat(torch.where(qualify, torch.clamp(qid, max=C + 1), C + 1))
    member = flat(qualify)
    mx = _segment("amax", torch.where(member, flat(x), -torch.inf), seg, C + 2, -torch.inf)
    return lead, qstart, qid, seg, member, mx


def _compact(mx, lead, C: int):
    """The cluster slots 1..C of [R, C + 2] as [..., C]."""
    return mx[:, 1 : C + 1].reshape(lead + (C,))


def cluster_fields(x, u1, u2, *, max_clusters: int):
    """Full cluster information (reference ``get_clusters_1d``), batched.

    x: [..., T]; u1 broadcasts against x (a threshold a row: [..., 1]); u2
    a scalar or the same.  Returns a dict of [..., C] tensors (C =
    ``max_clusters``): ``start``, ``end``, ``maxpos`` (int32, -1 padded),
    ``maximum`` (NaN padded), and ``nclusters`` [...] (every cluster, the
    dropped ones too).
    """
    x = as_tensor(x)
    T, C = x.shape[-1], max_clusters
    lead, qstart, qid, seg, member, mx = _cluster_maxima(x, u1, u2, C)
    R = seg.shape[0]
    xr = x.expand(lead + (T,)).reshape(R, T)
    idx = torch.arange(T, device=x.device).expand(R, T)
    st = _segment("amin", torch.where(member, idx, T), seg, C + 2, torch.iinfo(torch.int64).max)
    en = _segment("amax", torch.where(member, idx, -1), seg, C + 2, torch.iinfo(torch.int64).min)
    # the position of the maximum: the first member equal to it
    is_max = member & (xr == torch.gather(mx, -1, torch.clamp(qid.expand(lead + (T,)).reshape(R, T), max=C + 1)))
    mp = _segment("amin", torch.where(is_max, idx, T), seg, C + 2, torch.iinfo(torch.int64).max)

    mx, st, en, mp = (_compact(a, lead, C) for a in (mx, st, en, mp))
    valid = torch.isfinite(mx)
    pad = lambda a: torch.where(valid, a, -1).to(torch.int32)  # noqa: E731
    return {
        "start": pad(st),
        "end": pad(en),
        "maxpos": pad(mp),
        "maximum": torch.where(valid, mx, torch.nan),
        "nclusters": qstart.sum(dim=-1),
    }


def cluster_maxima(x, u1, u2, *, max_clusters: int):
    """Cluster maxima only: [..., C], NaN padded, compacted to the front
    (one segment reduction; no positions)."""
    x = as_tensor(x)
    lead, _, _, _, _, mx = _cluster_maxima(x, u1, u2, max_clusters)
    mx = _compact(mx, lead, max_clusters)
    return torch.where(torch.isfinite(mx), mx, torch.nan)
