"""N-pdf transform cores (the MBCn engine).

Port of reference ``_adjustment.py:289-465``: the per-site numpy loop over
rotations is a Python loop whose body is fully batched over the leading dims
(sites, group blocks): the V x V rotation, batched NaN-aware quantiles, ranks
and table lookups.  Composed rotation increments (``rot_i @ rot_{i-1}.T``,
reference ``_adjustment.py:311``) are precomputed so the loop carries the
*rotated* state instead of re-rotating from scratch.

Every rotation's factor lookup is ``ops/interp.py:interp1d_table``: on float32
CUDA tensors one launch of the row lookup kernel (K2,
``csrc/interp_kernel.cu``), whose ``nearest`` method is these schemes'
default; the quantile lerps go through ``ops/cuda/fma_kernel.py:fma``.  The
sorts, the rank's scans and scatter and the rotations are plain PyTorch; a
float32 rotation on CUDA runs in full float32 whatever cuBLAS's TF32
setting says (TF32 keeps 10 mantissa bits, and would move the first
rotation's factors by about 1e-3, float32 by about 1e-5).

MBCn's train and adjust loops are the spans ``npdft.train`` and
``npdft.adjust`` (``utils/profiling.py``), and each rotation they run adds 1
to the counter ``npdft.rotations``.
"""

from __future__ import annotations

import torch

from ..ops.escore import escore
from ..ops.interp import interp1d_table, interp_on_quantiles_grouped
from ..ops.quantile import _quantile_on_sorted, nan_quantile
from ..ops.rank import rank_pct_rescaled, rank_pct_rescaled_with_sorted
from ..ops.segment import gather_groups, grouped_rank, grouped_rank_and_quantile
from ..utils.profiling import count, span
from ..utils.tensor import as_tensor, full_float32_matmul, nanstd

__all__ = ["npdf_transform_core", "npdft_adjust_core", "npdft_train_core", "standardize_lastaxis"]


def standardize_lastaxis(x):
    """(x - nanmean) / nanstd along the last axis (ddof=0), as in
    reference ``_adjustment.py:303-305``."""
    mu = torch.nanmean(x, dim=-1, keepdim=True)
    sd = nanstd(x, axis=-1, keepdims=True)
    return (x - mu) / sd


def _composed_rots(rots):
    """rot increments: rots[0], rots[i] @ rots[i-1].T for i>0."""
    return torch.cat([rots[:1], _rotate(rots[1:], rots[:-1].transpose(-1, -2))], dim=0)


def _rotate(rot, x, transpose: bool = False):
    """``rot @ x`` over the variable axis of x [..., V, L] (``rot.T @ x``
    with ``transpose``): out[..., i, :] = sum_j rot[i, j] * x[..., j, :],
    in full float32 on the card (TF32 off)."""
    with full_float32_matmul():
        return torch.matmul(rot.transpose(-1, -2) if transpose else rot, x)


def _escore_stride(length: int, n_escore: int) -> int:
    """The step that thins ``length`` points to at most ``n_escore`` for the
    energy score (1: all points)."""
    return max(1, int(-(-length // n_escore))) if n_escore > 0 else 1


def npdft_train_core(ref, hist, rots, quantiles, *, interp: str, extrap: str, n_escore: int, standardize: bool = True):
    """Train the npdf transform.

    ref/hist: [..., V, L] (one windowed group block, NaN padded);
    rots: [I, V, V]; quantiles: [nq].
    Returns (af_q [..., I, V, nq], escores [..., I]).
    """
    r, h = as_tensor(ref), as_tensor(hist)
    if standardize:
        r = standardize_lastaxis(r)
        h = standardize_lastaxis(h)
    quantiles = as_tensor(quantiles, dtype=h.dtype, device=h.device)
    stride = _escore_stride(r.shape[-1], n_escore)
    af_qs, escores = [], []
    with span("npdft.train"):
        for rot in _composed_rots(as_tensor(rots, dtype=h.dtype, device=h.device)):
            count("npdft.rotations")
            r = _rotate(rot, r)
            h = _rotate(rot, h)
            ref_q = nan_quantile(r, quantiles, axis=-1)
            # hist side needs BOTH quantiles and ranks of the same array — one
            # shared value sort serves both (the sort is the iteration's
            # dominant cost; numerically identical to nan_quantile + rank)
            rnk, h_sorted, h_valid = rank_pct_rescaled_with_sorted(h, axis=-1)
            hist_q = _quantile_on_sorted(h_sorted, h_valid, quantiles, 1.0, 1.0)
            af_q = ref_q - hist_q
            h = h + interp1d_table(rnk, quantiles.expand(hist_q.shape), af_q, interp, extrap)
            # n_escore == 0 skips here (MBCn-train semantics, reference
            # _adjustment.py:308,325: `if n_escore > 0`) while the
            # NpdfTransform core below computes at 0 (adjustment.py:1034:
            # `>= 0`, "0 for all") — the reference's own asymmetry, kept
            if n_escore > 0:
                escores.append(escore(r[..., ::stride], h[..., ::stride]))
            else:
                escores.append(torch.full(r.shape[:-2], torch.nan, dtype=r.dtype, device=r.device))
            af_qs.append(af_q)
    return torch.stack(af_qs, dim=-3), torch.stack(escores, dim=-1)


def npdf_transform_core(
    ref,
    hist,
    sim,
    rots,
    quantiles,
    gather_h,
    group_idx_h,
    slot_h,
    gather_s,
    group_idx_s,
    slot_s,
    frac_h,
    pos_h,
    frac_s,
    pos_s,
    *,
    interp: str,
    extrap: str,
    n_escore: int,
    base: str = "qdm",
):
    """NpdfTransform engine (reference ``_adjustment.py:977-1057``).

    ref/hist [..., V, Th], sim [..., V, Ts].  Each step rotates the current
    hist/sim (and the fixed ref) with a fresh rotation, runs the grouped
    univariate ``base`` ("qdm": rank + factor lookup; "eqm": table lookup at
    the value) per variable, and rotates back.  Escore (vs the un-rotated
    ref, standardized by ref) tracks convergence.
    Returns (scenh, scens, escores).
    """
    ref = as_tensor(ref)
    h, s = as_tensor(hist, device=ref.device), as_tensor(sim, device=ref.device)
    quantiles = as_tensor(quantiles, dtype=ref.dtype, device=ref.device)
    stride = _escore_stride(ref.shape[-1], n_escore)
    # escore standardization by original ref (reference processing.py:460-480)
    mu = torch.nanmean(ref, dim=-1, keepdim=True)
    sd = nanstd(ref, axis=-1, keepdims=True, ddof=1)
    ref_n = ((ref - mu) / sd)[..., ::stride]

    escores = []
    for rot in as_tensor(rots, dtype=ref.dtype, device=ref.device):
        refp, hp, sp = _rotate(rot, ref), _rotate(rot, h), _rotate(rot, s)
        ref_q = nan_quantile(gather_groups(refp, gather_h), quantiles, axis=-1)
        if base == "qdm":
            # the hist side needs both its grouped ranks and its grouped
            # quantile tables — one gather + one value sort serves both
            rnk_h, hist_q = grouped_rank_and_quantile(hp, gather_h, group_idx_h, slot_h, quantiles)
            af = ref_q - hist_q                                      # [..., V, G, nq]
            qtab = quantiles.expand(af.shape)
            scenhp = hp + interp_on_quantiles_grouped(rnk_h, frac_h, qtab, af, pos_h, interp, extrap)
            rnk_s = grouped_rank(sp, gather_s, group_idx_s, slot_s, pct=True)
            scensp = sp + interp_on_quantiles_grouped(rnk_s, frac_s, qtab, af, pos_s, interp, extrap)
        else:  # eqm: look the value up in hist's quantile table
            hist_q = nan_quantile(gather_groups(hp, gather_h), quantiles, axis=-1)
            af = ref_q - hist_q
            scenhp = hp + interp_on_quantiles_grouped(hp, frac_h, hist_q, af, pos_h, interp, extrap)
            scensp = sp + interp_on_quantiles_grouped(sp, frac_s, hist_q, af, pos_s, interp, extrap)
        h = _rotate(rot, scenhp, transpose=True)
        s = _rotate(rot, scensp, transpose=True)
        if n_escore >= 0:
            escores.append(escore(ref_n, ((h - mu) / sd)[..., ::stride]))
        else:
            escores.append(torch.full(h.shape[:-2], torch.nan, dtype=h.dtype, device=h.device))
    return h, s, torch.stack(escores, dim=-1)


def npdft_adjust_core(sim, af_q, rots, quantiles, *, interp: str, extrap: str):
    """Apply stored npdft factors to (standardized) sim [..., V, L]
    (reference ``_adjustment.py:426-465``); af_q [..., I, V, nq]."""
    s = as_tensor(sim)
    af_q = as_tensor(af_q, device=s.device)
    rots = as_tensor(rots, dtype=s.dtype, device=s.device)
    quantiles = as_tensor(quantiles, dtype=s.dtype, device=s.device)
    with span("npdft.adjust"):
        for i, rot in enumerate(_composed_rots(rots)):
            count("npdft.rotations")
            afq = af_q[..., i, :, :]
            s = _rotate(rot, s)
            rnk = rank_pct_rescaled(s, axis=-1)
            s = s + interp1d_table(rnk, quantiles.expand(afq.shape), afq, interp, extrap)
        return _rotate(rots[-1], s, transpose=True)
