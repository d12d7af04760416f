"""Compute cores for the quantile-mapping schemes.

Each core is a plain function over dense tensors (time last) plus static
group-index tensors, on whatever device the data lies — the counterpart of
the reference's decorated compute functions (``_adjustment.py``).

Grouped lookups and broadcasts use *bracket partitions*
(``GroupIndexes.bracket_partitions``): static -1-padded partitions of the
time axis by bracketing padded group, so every step is either a batched
per-partition table evaluation or a gather from a long source axis.
Windowed dayofyear / "5D" groupings train through the counting-selection
engine (``ops/selquant.py``) or the merge engine of
``ops/quantile.py:windowed_group_quantile`` (``eqm_train_windowed``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.correction import apply_correction, get_correction, invert
from ..ops.cuda.fma_kernel import fma
from ..ops.interp import interp1d_table, interp_grouped_partitioned
from ..ops.quantile import _static_ok, _static_safe, _windowed_chunks, grouped_nan_quantile, nan_quantile, windowed_group_quantile
from ..ops.segment import gather_groups, grouped_rank
from ..ops.selquant import selection_ok, selection_windowed_quantile
from ..utils.profiling import span
from ..utils.tensor import as_tensor

__all__ = [
    "broadcast_groups_core",
    "dqm_train_core",
    "dqm_train_from_raw",
    "dqm_train_windowed",
    "eqm_train_adjust_windowed",
    "eqm_train_core",
    "eqm_train_from_raw",
    "eqm_train_windowed",
    "qdm_adjust_core",
    "qdm_train_adjust_core",
    "qm_adjust_core",
    "scaling_adjust_core",
    "scaling_train_core",
]


def _pad_cyclic_factors(f):
    """[..., G] -> [..., G+2] with one wrapped group on each side."""
    if f.shape[-1] > 1:
        return torch.cat([f[..., -1:], f, f[..., :1]], dim=-1)
    return f


def broadcast_groups_core(f, brackets, fused: bool = False):
    """Map per-group factors [..., G] onto the time axis [..., T] using
    bracket partitions (reference ``u.broadcast``, utils.py:180-248).

    ``fused`` rounds the blend of the two bracketing groups once, as
    ``fma(1 - ww, v0, ww * v1)``: what the JAX package's compiled cores
    (Scaling, LOCI) compute, where XLA contracts the blend.  Its eager
    caller (EQM's ``max_tail_factor`` mask) rounds every operation, and so
    does the default here."""
    part0, g0, slot0, part1, g1, slot1, w = brackets
    f = as_tensor(f)
    # partitions index padded groups (G+2) unless G == 1
    f_p = _pad_cyclic_factors(f) if part0.shape[0] != f.shape[-1] else f

    def eval_part(part, grp, slot):
        Lp = part.shape[-1]
        grid = f_p[..., None].expand(f_p.shape + (Lp,))
        return grid[..., grp, slot]

    v0 = eval_part(part0, g0, slot0)
    if part1 is None:
        return v0
    v1 = eval_part(part1, g1, slot1)
    ww = w.to(v0.dtype)
    if fused:
        return fma(1 - ww, v0, ww * v1)
    return (1 - ww) * v0 + ww * v1


def eqm_train_core(refg, histg, quantiles, *, kind: str):
    """EQM train on one batch: per-group quantiles of ref & hist, correction
    factors (reference ``_adjustment.py:193-286``).

    refg/histg: [..., G, L] gathered group matrices (NaN padded);
    quantiles: [nq].  Returns (af, hist_q): [..., G, nq].
    """
    ref_q = nan_quantile(refg, quantiles, axis=-1)
    hist_q = nan_quantile(histg, quantiles, axis=-1)
    af = get_correction(hist_q, ref_q, kind)
    return af, hist_q


def qm_adjust_core(sim, hist_q, af, brackets, *, kind: str, interp: str, extrapolation: str, tables_compact: bool = False):
    """QM adjust (reference ``_adjustment.py:594-676``): look up each sim value
    in the per-group (hist_q -> af) table, apply the correction.

    ``tables_compact``: the tables are quantile-trained (ascending, NaN rows
    whole) — skip the argsort NaN compaction (bit-identical there)."""
    with span("lookup"):
        if hist_q.shape[-2] == 1:
            af_t = interp1d_table(sim, hist_q[..., 0, :], af[..., 0, :], interp, extrapolation)
        else:
            af_t = interp_grouped_partitioned(
                sim, hist_q, af, *brackets, interp, extrapolation, tables_compact=tables_compact,
                steps=getattr(brackets, "steps", None),
            )
    return apply_correction(sim, af_t, kind)


def qdm_adjust_core(sim, af, quantiles, brackets, gather_sim, group_idx, scatter_slot, *, kind: str, interp: str, extrapolation: str):
    """QDM adjust (reference ``_adjustment.py:783-886``): per-group pct rank of
    sim, then af looked up at (rank, group) and applied.

    Returns (scen, sim_q)."""
    sim_q = grouped_rank(sim, gather_sim, group_idx, scatter_slot, pct=True)
    G, nq = af.shape[-2:]
    with span("lookup"):
        qtab = as_tensor(quantiles, dtype=sim.dtype, device=sim.device).expand(af.shape[:-2] + (G, nq))
        if G == 1:
            af_t = interp1d_table(sim_q, qtab[..., 0, :], af[..., 0, :], interp, extrapolation)
        else:
            # xq is the ascending quantile nodes and af is train output (whole-row
            # NaNs only): the argsort compaction is the identity — skip it
            af_t = interp_grouped_partitioned(
                sim_q, qtab, af, *brackets, interp, extrapolation, tables_compact=True,
                steps=getattr(brackets, "steps", None),
            )
    return apply_correction(sim, af_t, kind), sim_q


def qdm_train_adjust_core(ref, hist, sim, gather_idx, group_idx, scatter_slot, brackets, quantiles, *, kind: str, interp: str, extrapolation: str):
    """Fused QDM train + adjust — the headline single step.

    Grouped quantile estimation of ref & hist (gather->sort->lerp),
    adjustment factors, per-group pct ranks of sim, factor lookup,
    correction.  Purely batch-parallel over leading dims.
    """
    ref_q = nan_quantile(gather_groups(ref, gather_idx), quantiles, axis=-1)
    hist_q = nan_quantile(gather_groups(hist, gather_idx), quantiles, axis=-1)
    af = get_correction(hist_q, ref_q, kind)
    scen, _ = qdm_adjust_core(
        sim, af, quantiles, brackets, gather_idx, group_idx, scatter_slot,
        kind=kind, interp=interp, extrapolation=extrapolation,
    )
    return scen


def scaling_train_core(ref, hist, gather_ref, gather_hist, *, kind: str):
    """Scaling train (reference ``_adjustment.py:938-958``): group means."""
    mu_ref = torch.nanmean(gather_groups(ref, gather_ref), dim=-1)
    mu_hist = torch.nanmean(gather_groups(hist, gather_hist), dim=-1)
    return get_correction(mu_hist, mu_ref, kind)


def scaling_adjust_core(sim, af, brackets, *, kind: str):
    """Scaling adjust (reference ``_adjustment.py:961-974``); the group
    blend rounded once, as the JAX package's compiled core rounds it."""
    af_t = broadcast_groups_core(af, brackets, fused=True)
    return apply_correction(sim, af_t, kind)


def eqm_train_from_raw(ref, hist, gather_idx, quantiles, *, kind: str):
    """EQM train straight from [..., T] tensors with memory-bounded chunking
    over groups (no full [..., G, L] gather materialized)."""
    ref_q = grouped_nan_quantile(ref, gather_idx, quantiles)
    hist_q = grouped_nan_quantile(hist, gather_idx, quantiles)
    return get_correction(hist_q, ref_q, kind), hist_q


def _eqm_train_windowed_fused(ref, hist, plan, quantiles, *, kind: str, static: bool):
    """Windowed EQM train of a matching (ref, hist) pair: one stacked pass
    of the merge engine (grouped quantiles of both) and the factors
    (reference ``_algos.py:314-343``).  ``static`` picks the host-count
    extraction; the caller has checked that it is value-safe."""
    q2 = _windowed_chunks(torch.stack([ref, hist]), plan, quantiles, static=static)
    return get_correction(q2[1], q2[0], kind), q2[1]


def _sel_fused_ok(plan, ref, hist, quantiles) -> bool:
    """The fused selection train applies (reference ``_algos.py:379-393``):
    the selection engine serves the call, ref and hist match, and the
    stage-3 block gather of the stacked batch stays within 2^31 elements."""
    if not (selection_ok(plan, quantiles, ref.device) and ref.shape == hist.shape and ref.dtype == hist.dtype):
        return False
    B2 = 2 * int(np.prod(ref.shape[:-1], dtype=np.int64))
    G = int(plan.fast_mask.shape[0])
    K = 2 * int(np.shape(quantiles)[0]) + 1
    return B2 * G * K * 128 <= (1 << 31)


def _eqm_train_windowed_sel(ref, hist, plan, quantiles, *, kind: str):
    """Windowed EQM train of a matching pair on the counting-selection
    engine: one stacked NaN-exact pass and the factors (reference
    ``_algos.py:346-356``)."""
    q2 = selection_windowed_quantile(torch.stack([ref, hist]), plan, quantiles)
    return get_correction(q2[1], q2[0], kind), q2[1]


def eqm_train_windowed(ref, hist, plan, quantiles, *, kind: str, assume_finite: bool | None = None):
    """EQM train on a windowed dayofyear / "5D" grouping
    (``ops/quantile.windowed_group_quantile``): the same tables as
    ``eqm_train_from_raw`` on that grouping.  A matching pair the selection
    engine serves (``_sel_fused_ok``) takes one stacked selection pass and
    ignores ``assume_finite``.  Otherwise the merge engine sorts each
    window-1 list once instead of ``window`` times; a matching pair shares
    one stacked pass and one finiteness check (reference
    ``_algos.py:525-601``), and ``assume_finite`` pins that pair's
    extraction: True the static one (the caller promises rows that are all
    finite or all NaN), False the dynamic one; None checks the data (one
    host synchronisation)."""
    ref, hist = as_tensor(ref), as_tensor(hist)
    if _sel_fused_ok(plan, ref, hist, quantiles):
        return _eqm_train_windowed_sel(ref, hist, plan, quantiles, kind=kind)
    if ref.shape == hist.shape and ref.dtype == hist.dtype:
        finite = _static_safe(ref, hist) if assume_finite is None else bool(assume_finite)
        static = _static_ok(plan, quantiles) and finite
        return _eqm_train_windowed_fused(ref, hist, plan, quantiles, kind=kind, static=static)
    ref_q = windowed_group_quantile(ref, plan, quantiles)
    hist_q = windowed_group_quantile(hist, plan, quantiles)
    return get_correction(hist_q, ref_q, kind), hist_q


def eqm_train_adjust_windowed(
    ref, hist, sim, plan, quantiles, brackets, *,
    kind: str, interp: str = "linear", extrapolation: str = "constant", assume_finite: bool | None = None,
):
    """Windowed EQM train + adjust, the doy+window production step:
    ``eqm_train_windowed`` followed by ``qm_adjust_core`` (reference
    ``_algos.py:396-522``; eager PyTorch has no program boundary to fuse
    across, so the reference's fused program is this sequence).  Returns
    (scen, af, hist_q); ``assume_finite`` as for ``eqm_train_windowed``."""
    af, hist_q = eqm_train_windowed(ref, hist, plan, quantiles, kind=kind, assume_finite=assume_finite)
    scen = qm_adjust_core(
        as_tensor(sim), hist_q, af, brackets, kind=kind, interp=interp, extrapolation=extrapolation, tables_compact=True,
    )
    return scen, af, hist_q


def _normalized_tables(refg, histg, quantiles, kind: str, fused: bool = True):
    """DQM's tables of gathered groups: quantiles of ref and hist normalized
    by their group means, the factors between them and the means (reference
    ``_algos.py:251-261``); ``fused`` as for ``ops/quantile.nan_quantile``."""
    mu_ref = torch.nanmean(refg, dim=-1)
    mu_hist = torch.nanmean(histg, dim=-1)
    refn = apply_correction(refg, invert(mu_ref[..., None], kind), kind)
    histn = apply_correction(histg, invert(mu_hist[..., None], kind), kind)
    ref_q = nan_quantile(refn, quantiles, axis=-1, fused=fused)
    hist_q = nan_quantile(histn, quantiles, axis=-1, fused=fused)
    return get_correction(hist_q, ref_q, kind), hist_q, mu_ref, mu_hist


def dqm_train_core(refg, histg, quantiles, *, kind: str):
    """DQM train on gathered group rows [..., G, L], the path after frequency
    adaptation (reference ``models/dqm.py:103-112``).  The JAX package runs
    it eagerly, so the type-7 arithmetic is rounded unfused (ROADMAP C11).
    Returns (af, hist_q [..., G, nq], scaling [..., G])."""
    af, hist_q, mu_ref, mu_hist = _normalized_tables(refg, histg, quantiles, kind, fused=False)
    return af, hist_q, get_correction(mu_hist, mu_ref, kind)


def dqm_train_from_raw(ref, hist, gather_idx, quantiles, *, kind: str):
    """DQM train (normalized quantiles and the scaling factor) straight from
    [..., T] tensors, the groups taken in blocks that keep a gathered block
    near 2^28 values (reference ``_algos.py:239-283``).  Returns (af,
    hist_q [..., G, nq], scaling [..., G])."""
    ref, hist = as_tensor(ref), as_tensor(hist)
    gather_idx = as_tensor(gather_idx, device=ref.device)
    G, L = gather_idx.shape
    batch = int(np.prod(ref.shape[:-1], dtype=np.int64))
    chunk = max(1, min(G, (1 << 28) // max(batch * L, 1)))
    parts = [
        _normalized_tables(gather_groups(ref, gather_idx[k : k + chunk]), gather_groups(hist, gather_idx[k : k + chunk]), quantiles, kind)
        for k in range(0, G, chunk)
    ]
    af, hist_q, mu_ref, mu_hist = (torch.cat(p, dim=-2 if i < 2 else -1) for i, p in enumerate(zip(*parts)))
    return af, hist_q, get_correction(mu_hist, mu_ref, kind)


def _windowed_group_mean(x, plan):
    """Per-group NaN-mean of a windowed dayofyear / "5D" grouping from
    sliding sums of the window-1 groups' sums and counts (a cumulative sum
    over the extended window-1 rows), the edge groups gathered exactly
    (reference ``_algos.py:286-311``)."""
    x = as_tensor(x)
    gi = torch.as_tensor(plan.w1_gather, device=x.device).long()   # extended rows: [G + 2*half, Ymax]
    vals = torch.where(gi < 0, torch.nan, x[..., torch.clamp(gi, 0, x.shape[-1] - 1)])
    sums = torch.nansum(vals, dim=-1)
    cnts = (~torch.isnan(vals)).sum(dim=-1)
    half, window = plan.half, plan.window
    G = gi.shape[0] - 2 * half
    idx = torch.arange(G, device=x.device)

    def slide(a):
        # group g's window is the extended rows [g, g + window)
        cs = torch.cumsum(torch.nn.functional.pad(a, (0, max(window - 2 * half, 0))), dim=-1)
        cs = torch.nn.functional.pad(cs, (1, 0))
        return cs[..., idx + window] - cs[..., idx]

    n = slide(cnts)
    mu = torch.where(n == 0, torch.nan, slide(sums) / torch.clamp(n, min=1))
    if plan.edge_gather.shape[0]:
        mu[..., torch.as_tensor(plan.edge_ids, device=x.device).long()] = torch.nanmean(gather_groups(x, plan.edge_gather), dim=-1)
    return mu


def dqm_train_windowed(ref, hist, plan, quantiles, *, kind: str):
    """DQM train on a windowed dayofyear / "5D" grouping (reference
    ``_algos.py:604-632``).  A group's mean normalization commutes with its
    quantiles (an additive shift or a positive scale keeps the order; a
    negative multiplicative mean reverses it, so the quantile axis is
    flipped there), so the normalized tables come from the raw values'
    windowed quantiles (``ops/quantile.windowed_group_quantile``: on CUDA
    the merge engine) and the windowed group means, without sorting
    normalized copies.  Returns (af, hist_q [..., G, nq], scaling [..., G])."""
    ref, hist = as_tensor(ref), as_tensor(hist)
    if ref.shape == hist.shape and ref.dtype == hist.dtype:
        ref_q_raw, hist_q_raw = windowed_group_quantile(torch.stack([ref, hist]), plan, quantiles)
    else:
        ref_q_raw = windowed_group_quantile(ref, plan, quantiles)
        hist_q_raw = windowed_group_quantile(hist, plan, quantiles)
    mu_ref = _windowed_group_mean(ref, plan)
    mu_hist = _windowed_group_mean(hist, plan)

    def normalize(q_raw, mu):
        if kind == "*":
            q_raw = torch.where(mu[..., None] < 0, torch.flip(q_raw, dims=(-1,)), q_raw)
        return apply_correction(q_raw, invert(mu[..., None], kind), kind)

    ref_q = normalize(ref_q_raw, mu_ref)
    hist_q = normalize(hist_q_raw, mu_hist)
    return get_correction(hist_q, ref_q, kind), hist_q, get_correction(mu_hist, mu_ref, kind)
