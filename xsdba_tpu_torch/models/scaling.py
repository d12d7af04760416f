"""Scaling and LOCI adjustments.

Reference: ``adjustment.py:933-1050`` (classes), ``_adjustment.py:889-974``
(compute).  Both are group-mean methods: a gather into group rows, a NaN-aware
reduction, and a broadcast of the per-group factors back onto the time axis,
blended between the two bracketing groups under ``interp="linear"``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.correction import ADDITIVE, MULTIPLICATIVE, get_correction
from ..ops.cuda.fma_kernel import fma
from ..ops.quantile import vecquantiles
from ..ops.segment import gather_groups
from ..utils.container import DataArray, Dataset
from ..utils.grouper import Grouper
from ..utils.tensor import _check_leading, as_tensor
from ..utils.units import convert_units_to
from . import _algos
from ._wrap import device_brackets, grouped_var, scen_like, to_compute, training_tensors
from .base import TrainAdjust

__all__ = ["LOCI", "Scaling"]


class Scaling(TrainAdjust):
    """Scale ref/hist group means onto sim (reference adjustment.py:1005-1050)."""

    _allow_diff_calendars = False
    _allow_diff_training_times = False

    @classmethod
    def _train(cls, ref: DataArray, hist: DataArray, *, group: str | Grouper = "time", kind: str = ADDITIVE) -> tuple[Dataset, dict[str, Any]]:
        group = Grouper(group) if isinstance(group, str) else group
        refa, hista, bdims, bcoords, gi, gi_t = training_tensors(group, ref, hist)
        af = _algos.scaling_train_core(refa, hista, gi_t.gather_idx, gi_t.gather_idx, kind=kind)
        ds = Dataset({"af": grouped_var(af, bdims, bcoords, gi, name="af", attrs={"standard_name": "Adjustment factors"})})
        return ds, {"group": group, "kind": kind}

    def _adjust(self, sim: DataArray, interp: str = "nearest"):
        gi = self.group.indexes(sim.time)
        sima, _, _ = to_compute(sim)
        scen = _algos.scaling_adjust_core(
            sima,
            as_tensor(self.ds["af"].data, device=sima.device),
            device_brackets(gi, interp, sima.device),
            kind=self.kind,
        )
        return scen_like(sim, scen)


def _loci_train_core(refg, histg, thresh):
    """LOCI train (reference ``_adjustment.py:889-915``): map the wet-day
    threshold into hist-space per group, ratio of mean exceedances."""
    q = torch.nanmean(torch.where(torch.isnan(refg), torch.nan, (refg <= thresh).to(refg.dtype)), dim=-1)
    s_thresh = vecquantiles(histg, q, axis=-1)
    ws = torch.where(histg >= s_thresh[..., None], histg, torch.nan)
    wo = torch.where(refg >= thresh, refg, torch.nan)
    ms = torch.nanmean(ws, dim=-1)
    mo = torch.nanmean(wo, dim=-1)
    af = get_correction(ms - s_thresh, mo - thresh, MULTIPLICATIVE)
    return af, s_thresh


def _loci_adjust_core(sima, af, hist_thresh, thresh, brackets):
    """LOCI adjust (reference ``_adjustment.py:918-935``):
    ``(af * (sim - sth) + thresh).clip(0)``, the group blends and the
    multiply-add each rounded once, as the JAX package's compiled core
    rounds them."""
    sth = _algos.broadcast_groups_core(hist_thresh, brackets, fused=True)
    fac = _algos.broadcast_groups_core(af, brackets, fused=True)
    _check_leading(sima.shape[:-1], sth.shape[:-1])
    return torch.clamp(fma(fac, sima - sth, thresh.expand_as(sima)), min=0)


class LOCI(TrainAdjust):
    """Local Intensity Scaling — wet-day threshold mapping + intensity scaling
    (Schmidli et al. 2006; reference adjustment.py:933-1002)."""

    _allow_diff_calendars = False
    _allow_diff_training_times = False

    @classmethod
    def _train(cls, ref: DataArray, hist: DataArray, *, thresh: str, group: str | Grouper = "time") -> tuple[Dataset, dict[str, Any]]:
        group = Grouper(group) if isinstance(group, str) else group
        th = convert_units_to(thresh, ref.units)
        refa, hista, bdims, bcoords, gi, gi_t = training_tensors(group, ref, hist)
        refg = gather_groups(refa, gi_t.gather_idx)
        histg = gather_groups(hista, gi_t.gather_idx)
        af, s_thresh = _loci_train_core(refg, histg, torch.as_tensor(th, dtype=refa.dtype, device=refa.device))
        ds = Dataset(
            {
                "af": grouped_var(af, bdims, bcoords, gi, name="af", attrs={"standard_name": "Adjustment factors"}),
                "hist_thresh": grouped_var(s_thresh, bdims, bcoords, gi, name="hist_thresh", attrs={"units": ref.units}),
            }
        )
        return ds, {"group": group, "thresh": th}

    def _adjust(self, sim: DataArray, interp: str = "linear"):
        gi = self.group.indexes(sim.time)
        sima, _, _ = to_compute(sim)
        scen = _loci_adjust_core(
            sima,
            as_tensor(self.ds["af"].data, device=sima.device),
            as_tensor(self.ds["hist_thresh"].data, device=sima.device),
            torch.as_tensor(self.thresh, dtype=sima.dtype, device=sima.device),
            device_brackets(gi, interp, sima.device),
        )
        return scen_like(sim, scen)
