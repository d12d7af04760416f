"""Plain MBCn: the npdf transform's train, then its adjust, site by site.

The semantics the port states for ``MBCn.train(ref, hist, base_kws=...,
adj_kws=..., n_iter=..., n_escore=-1, rot_matrices=...)`` then
``.adjust(sim, ref, hist, base_kws_vars=..., adj_kws=...)`` with
``group="time"``, written out in NumPy float64, with no code or data of the
port (Cannon 2018; xsdba's ``_adjustment.py:289-591``):

- train: each variable of ref and hist standardised by its own mean and
  standard deviation (ddof 0); then for each rotation ``R_i`` the state is
  turned by the increment ``R_0`` or ``R_i R_{i-1}^T``; per variable, the
  type-7 quantiles of ref and hist at the nodes ``(k + 0.5) / nq`` give
  ``af_q = ref_q - hist_q``, and hist moves by the factor looked up at its
  rescaled percent rank;
- adjust: (1) per variable, a QDM of the raw series trained on the whole
  period (``kind`` ``"+"``, or ``"*"`` where ``base_kws_vars`` says so):
  factors ``ref_q - hist_q`` or ``ref_q / hist_q``, looked up at sim's
  rescaled percent rank and added or multiplied; (2) sim standardised,
  then turned and moved by the stored factors rotation by rotation as in
  train, then turned back by the last rotation's transpose; (3) the Schaake
  reordering: the QDM series sorted, each day taking the value whose place
  is the day's rank in (2) (stable, NaN last);
- ranks: average ranks of ties over the valid values, divided by their
  count, then rescaled so that the lowest is 0 and the highest keeps its
  value (xsdba's ``rank(pct=True)``); NaN stays NaN;
- lookup: ``nearest`` with constant extrapolation: the factor of the node
  nearest the rank, the lower node where two are equally near (scipy's
  ``interp1d(kind="nearest")``), so that ranks beyond the first or last
  node take its factor.

Departures from xsdba, none of which a run of this configuration meets
with sim as long as ref and no NaN:

- xsdba ranks the npdft state with ``_rank_bn`` (``rank / max(rank)``
  rescaled to [0, 1]) and QDM's series with ``rank(pct=True)`` rescaled;
  here one rank serves both, which equal each other where the highest
  value has no tie;
- xsdba's reordering takes ``argsort(argsort(ref))`` with NumPy's default
  (unstable) sort; here both sorts are stable, which differ only on ties;
- escores (``n_escore=-1``) and ``period_dim`` are left out;
- the univariate QDM runs on the whole series (``group="time"``); xsdba's
  windowed blocks are not written here.

``rnd`` rounds each stage's result (inputs, standardised and turned
states, quantiles, factors, ranks, looked-up factors, QDM series, the
reordered scen); the identity gives the float64 reference, and
``qm.bfloat16`` the control the comparison has to reject.
"""

from __future__ import annotations

import numpy as np


def identity(x):
    return x


def nodes(nquantiles: int) -> np.ndarray:
    return (np.arange(nquantiles) + 0.5) / nquantiles


def standardize(x: np.ndarray) -> np.ndarray:
    """(x - mean) / std over the last axis (ddof 0), NaN left out."""
    mu = np.nanmean(x, axis=-1, keepdims=True)
    return (x - mu) / np.sqrt(np.nanmean((x - mu) ** 2, axis=-1, keepdims=True))


def quantiles(x: np.ndarray, q: np.ndarray, v: np.ndarray | None = None) -> np.ndarray:
    """Type-7 quantiles [..., nq] of the valid values of each row of x
    [..., T] (``v``: the rows sorted, NaN last, where they are at hand)."""
    v = np.sort(x, axis=-1) if v is None else v                    # NaN last
    n = (~np.isnan(x)).sum(axis=-1, keepdims=True)
    h = (np.maximum(n, 1) - 1) * q
    lo = np.floor(h).astype(np.int64)
    a = np.take_along_axis(v, lo, axis=-1)
    b = np.take_along_axis(v, np.minimum(lo + 1, np.maximum(n, 1) - 1), axis=-1)
    return np.where(n > 0, a + (h - lo) * (b - a), np.nan)


def pct_ranks(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rescaled percent ranks of each row of x [..., T] (see the module
    docstring), and the rows sorted with NaN last: a value's rank is the
    mean of the first and last places of its run of equal values in the
    sorted row, counted from 1."""
    nan = np.isnan(x)
    key = np.where(nan, np.inf, x)
    perm = np.argsort(key, axis=-1, kind="stable")
    s = np.take_along_axis(key, perm, axis=-1)
    n = x.shape[-1]
    pos = np.broadcast_to(np.arange(n), s.shape)
    starts = np.ones(s.shape, dtype=bool)
    starts[..., 1:] = s[..., 1:] != s[..., :-1]
    ends = np.ones_like(starts)
    ends[..., :-1] = starts[..., 1:]
    first = np.maximum.accumulate(np.where(starts, pos, 0), axis=-1)
    last = np.minimum.accumulate(np.where(ends, pos, n)[..., ::-1], axis=-1)[..., ::-1]
    rank = np.empty(s.shape)
    np.put_along_axis(rank, perm, (first + last) / 2 + 1, axis=-1)
    count = (~nan).sum(axis=-1, keepdims=True)
    r = np.where(nan, np.nan, rank / np.maximum(count, 1))
    mn = np.where(nan, np.inf, r).min(axis=-1, keepdims=True)
    mx = np.where(nan, -np.inf, r).max(axis=-1, keepdims=True)
    flat = mx == mn
    r = np.where(nan, np.nan, np.where(flat, 0.0, mx * (r - mn) / np.where(flat, 1.0, mx - mn)))
    return r, np.where(np.isinf(s) & (pos >= count), np.nan, s)


def nearest(v: np.ndarray, xq: np.ndarray, yq: np.ndarray) -> np.ndarray:
    """y of the node of xq [nq] (ascending) nearest each value of v [..., T]
    (the lower one where a value lies halfway, as scipy's search of the
    midpoints finds it), yq [..., nq] per row; NaN for a NaN value."""
    k = np.searchsorted((xq[1:] + xq[:-1]) / 2, v)                # the midpoints below each value
    out = np.take_along_axis(yq, np.minimum(k, len(xq) - 1), axis=-1)
    return np.where(np.isnan(v), np.nan, out)


def turn(rot: np.ndarray, x: np.ndarray) -> np.ndarray:
    """rot @ x over the variable axis of x [S, V, T]."""
    return np.einsum("ij,sjt->sit", rot, x)


def increments(rots: np.ndarray) -> list[np.ndarray]:
    return [rots[0]] + [rots[i] @ rots[i - 1].T for i in range(1, len(rots))]


def train(ref: np.ndarray, hist: np.ndarray, rots: np.ndarray, q: np.ndarray, r) -> np.ndarray:
    """af_q [S, I, V, nq] of the npdf transform of ref and hist [S, V, T]."""
    x, h = r(standardize(ref)), r(standardize(hist))
    af_q = []
    for inc in increments(rots):
        x, h = r(turn(inc, x)), r(turn(inc, h))
        rank, h_sorted = pct_ranks(h)
        af = r(r(quantiles(x, q)) - r(quantiles(h, q, h_sorted)))     # [S, V, nq]
        h = r(h + r(nearest(r(rank), q, af)))
        af_q.append(af)
    return np.stack(af_q, axis=1)


def npdft_adjust(sim: np.ndarray, af_q: np.ndarray, rots: np.ndarray, q: np.ndarray, r) -> np.ndarray:
    """sim [S, V, T] moved by the stored factors, in the unrotated frame."""
    s = r(standardize(sim))
    for i, inc in enumerate(increments(rots)):
        s = r(turn(inc, s))
        s = r(s + r(nearest(r(pct_ranks(s)[0]), q, af_q[:, i])))
    return r(turn(rots[-1].T, s))


def qdm(ref: np.ndarray, hist: np.ndarray, sim: np.ndarray, q: np.ndarray, kind: str, r) -> np.ndarray:
    """Whole-series QDM of one variable's rows [S, T]."""
    ref_q, hist_q = r(quantiles(ref, q)), r(quantiles(hist, q))
    af = r(ref_q / hist_q if kind == "*" else ref_q - hist_q)
    af_t = r(nearest(r(pct_ranks(sim)[0]), q, af))
    return r(sim * af_t if kind == "*" else sim + af_t)


def reorder(order_by: np.ndarray, x: np.ndarray) -> np.ndarray:
    """x's values placed in ``order_by``'s rank order along the last axis."""
    ranks = np.argsort(np.argsort(order_by, axis=-1, kind="stable"), axis=-1, kind="stable")
    return np.take_along_axis(np.sort(x, axis=-1, kind="stable"), ranks, axis=-1)


def train_adjust(config: dict, inputs: dict, days: dict, rnd=identity) -> dict:
    """{output: rows} of ``config``'s MBCn train + adjust on the site rows
    ``inputs`` (ref, hist [S, V, T_train], sim [S, V, T_sim] with
    T_sim = T_train) over ``days``: ``scen`` [S, V, T_sim] and ``af_q``
    [S, 1, I, V, nq], the trained factors in the port's layout (one group,
    ``group="time"``)."""
    tr, adj = config["train"], config["adjust"]
    if tr["base_kws"].get("group", "time") != "time":
        raise NotImplementedError("the plain reference covers group='time'")
    for kws in (tr["adj_kws"], adj["adj_kws"]):
        if (kws["interp"], kws["extrapolation"]) != ("nearest", "constant"):
            raise NotImplementedError("the plain reference covers nearest interpolation and constant extrapolation")
    if days["sim"].n != days["train"].n:
        raise ValueError("MBCn adjusts a sim as long as ref")
    ref, hist, sim = (rnd(np.asarray(inputs[k], dtype=np.float64)) for k in ("ref", "hist", "sim"))
    rots = np.asarray(tr["rot_matrices"], dtype=np.float64)[: int(tr["n_iter"])]
    q = nodes(int(tr["base_kws"]["nquantiles"]))
    af_q = train(ref, hist, rots, q, rnd)
    kinds = [adj.get("base_kws_vars", {}).get(str(v), {}).get("kind", "+") for v in range(ref.shape[1])]
    uni = np.stack([qdm(ref[:, v], hist[:, v], sim[:, v], q, kinds[v], rnd) for v in range(ref.shape[1])], axis=1)
    scen = rnd(reorder(npdft_adjust(sim, af_q, rots, q, rnd), uni))
    return {"scen": scen, "af_q": af_q[:, None]}
