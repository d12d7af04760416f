"""Compute cores for the quantile-mapping schemes.

Each core is a plain function over dense tensors (time last) plus static
group-index tensors, on whatever device the data lies — the counterpart of
the reference's decorated compute functions (``_adjustment.py``).

Grouped lookups and broadcasts use *bracket partitions*
(``GroupIndexes.bracket_partitions``): static -1-padded partitions of the
time axis by bracketing padded group, so every step is either a batched
per-partition table evaluation or a gather from a long source axis.
Windowed dayofyear / "5D" groupings train through the merge engine of
``ops/quantile.py:windowed_group_quantile`` (``eqm_train_windowed``).
"""

from __future__ import annotations

import torch

from ..ops.correction import apply_correction, get_correction
from ..ops.interp import interp1d_table, interp_grouped_partitioned
from ..ops.quantile import _static_ok, _static_safe, _windowed_chunks, grouped_nan_quantile, nan_quantile, windowed_group_quantile
from ..ops.segment import gather_groups, grouped_rank
from ..utils.tensor import as_tensor

__all__ = [
    "broadcast_groups_core",
    "eqm_train_adjust_windowed",
    "eqm_train_core",
    "eqm_train_from_raw",
    "eqm_train_windowed",
    "qdm_adjust_core",
    "qdm_train_adjust_core",
    "qm_adjust_core",
]


def _pad_cyclic_factors(f):
    """[..., G] -> [..., G+2] with one wrapped group on each side."""
    if f.shape[-1] > 1:
        return torch.cat([f[..., -1:], f, f[..., :1]], dim=-1)
    return f


def broadcast_groups_core(f, brackets):
    """Map per-group factors [..., G] onto the time axis [..., T] using
    bracket partitions (reference ``u.broadcast``, utils.py:180-248)."""
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
    if hist_q.shape[-2] == 1:
        af_t = interp1d_table(sim, hist_q[..., 0, :], af[..., 0, :], interp, extrapolation)
    else:
        af_t = interp_grouped_partitioned(
            sim, hist_q, af, *brackets, interp, extrapolation, tables_compact=tables_compact
        )
    return apply_correction(sim, af_t, kind)


def qdm_adjust_core(sim, af, quantiles, brackets, gather_sim, group_idx, scatter_slot, *, kind: str, interp: str, extrapolation: str):
    """QDM adjust (reference ``_adjustment.py:783-886``): per-group pct rank of
    sim, then af looked up at (rank, group) and applied.

    Returns (scen, sim_q)."""
    sim_q = grouped_rank(sim, gather_sim, group_idx, scatter_slot, pct=True)
    G, nq = af.shape[-2:]
    qtab = as_tensor(quantiles, dtype=sim.dtype, device=sim.device).expand(af.shape[:-2] + (G, nq))
    if G == 1:
        af_t = interp1d_table(sim_q, qtab[..., 0, :], af[..., 0, :], interp, extrapolation)
    else:
        # xq is the ascending quantile nodes and af is train output (whole-row
        # NaNs only): the argsort compaction is the identity — skip it
        af_t = interp_grouped_partitioned(
            sim_q, qtab, af, *brackets, interp, extrapolation, tables_compact=True
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


def eqm_train_windowed(ref, hist, plan, quantiles, *, kind: str, assume_finite: bool | None = None):
    """EQM train on a windowed dayofyear / "5D" grouping through the merge
    engine (``ops/quantile.windowed_group_quantile``): the same tables as
    ``eqm_train_from_raw`` on that grouping, with each window-1 list sorted
    once instead of ``window`` times.  A matching pair shares one stacked
    pass and one finiteness check (reference ``_algos.py:525-601``);
    ``assume_finite`` pins that pair's extraction: True the static one (the
    caller promises rows that are all finite or all NaN), False the dynamic
    one; None checks the data (one host synchronisation)."""
    ref, hist = as_tensor(ref), as_tensor(hist)
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
