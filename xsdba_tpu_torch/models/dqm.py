"""Detrended Quantile Mapping (reference ``adjustment.py:531-671``,
``_adjustment.py:86-190,679-780``).

Port of ``xsdba_tpu/models/dqm.py``.  Train: EQM on ref and hist normalized
by their group means, and the ratio (or difference) of those means as a
scaling factor.  Adjust: scale sim, remove its trend (polynomial, LOESS, ...),
quantile-map the detrended series, put the trend back.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from ..detrending import BaseDetrend, PolyDetrend
from ..ops.correction import ADDITIVE, apply_correction, equally_spaced_nodes
from ..ops.quantile import grouped_nan_quantile
from ..utils.container import DataArray, Dataset
from ..utils.grouper import Grouper
from ..utils.options import EXTRA_OUTPUT, get_option
from ..utils.tensor import as_tensor, numpy_dtype
from . import _algos
from ._wrap import device_brackets, grouped_var, scen_like, to_compute, training_tensors
from .base import TrainAdjust
from .eqm import (
    _add_preprocess_vars,
    _adjust_preprocess,
    _apply_jitter,
    _apply_max_tail_mask,
    _preprocess,
    _reference_af_lookup,
    _use_reference_interp,
)

__all__ = ["DetrendedQuantileMapping"]


def _scaled(sima, scaling, gi, interp: str, kind: str):
    """sim times (or plus) its group's scaling factor (reference
    ``_adjustment.py:745-753``; dayofyear groups take the nearest one).
    The JAX package computes this eagerly, so the bracket blend rounds every
    operation (ROADMAP C11)."""
    interp_b = interp if gi.prop != "dayofyear" else "nearest"
    scaling_t = _algos.broadcast_groups_core(as_tensor(scaling, device=sima.device), device_brackets(gi, interp_b, sima.device))
    return apply_correction(sima, scaling_t, kind)


class DetrendedQuantileMapping(TrainAdjust):
    r"""DQM: quantile mapping of detrended, mean-scaled data (Cannon et al.
    2015; reference adjustment.py:531-671).

    ``train`` takes the parameters of EQM's (``nquantiles``, ``kind``,
    ``group``, the dry-day preprocessing, ``max_tail_factor``); a windowed
    dayofyear or "5D" group trains through ``ops/quantile.py``'s windowed
    quantile (the merge engine on CUDA).  ``adjust`` takes ``interp``,
    ``extrapolation``, ``detrend`` (a polynomial degree or a
    :class:`~xsdba_tpu_torch.detrending.BaseDetrend`) and ``mode``; under the
    ``extra_output`` option it returns the fitted ``trend`` beside ``scen``.
    """

    _allow_diff_calendars = False
    _allow_diff_training_times = False

    @classmethod
    def _train(
        cls,
        ref: DataArray,
        hist: DataArray,
        *,
        nquantiles: int | np.ndarray = 20,
        kind: str = ADDITIVE,
        group: str | Grouper = "time",
        adapt_freq_thresh: str | None = None,
        jitter_under_thresh_value: str | None = None,
        jitter_over_thresh_value: str | None = None,
        jitter_over_thresh_upper_bnd: str | None = None,
        max_tail_factor: float | None = None,
    ) -> tuple[Dataset, dict[str, Any]]:
        group = Grouper(group) if isinstance(group, str) else group
        if group.prop not in ("group", "dayofyear"):
            warnings.warn(
                f"DQM is best used with 'time' or 'time.dayofyear' grouping, got {group.name} "
                "(reference adjustment.py:608-609).",
                stacklevel=4,
            )
        quantiles = equally_spaced_nodes(int(nquantiles)) if np.isscalar(nquantiles) else np.asarray(nquantiles)

        refa, hista, bdims, bcoords, gi, gi_t = training_tensors(group, ref, hist)
        quantiles = quantiles.astype(numpy_dtype(refa.dtype))
        q_t = torch.as_tensor(quantiles, device=refa.device)
        gather_idx = torch.as_tensor(gi_t.gather_idx, device=refa.device)

        # quantiles of hist before preprocessing (reference _adjustment.py:146-149)
        hist_q_raw = grouped_nan_quantile(hista, gather_idx, q_t) if max_tail_factor is not None else None
        hista = _apply_jitter(hista, hist, jitter_under_thresh_value, jitter_over_thresh_value, jitter_over_thresh_upper_bnd)
        if adapt_freq_thresh is not None:
            refg, histg, P0_ref, P0_hist, pth = _preprocess(refa, hista, gi_t, hist, adapt_freq_thresh)
            # mean-normalized within each group (reference _adjustment.py:165-168)
            af, hist_q, scaling = _algos.dqm_train_core(refg, histg, q_t, kind=kind)
        elif gi_t.merge_plan is not None:
            # windowed groupings: the normalization commutes with the
            # quantiles, which the windowed engines compute from the raw values
            af, hist_q, scaling = _algos.dqm_train_windowed(refa, hista, gi_t.merge_plan, q_t, kind=kind)
        else:
            # memory-bounded path: the groups gathered a block at a time
            af, hist_q, scaling = _algos.dqm_train_from_raw(refa, hista, gather_idx, q_t, kind=kind)

        qdim = ("quantiles", quantiles)
        ds = Dataset(
            {
                "af": grouped_var(af, bdims, bcoords, gi, qdim, name="af", attrs={"standard_name": "Adjustment factors"}),
                "hist_q": grouped_var(hist_q, bdims, bcoords, gi, qdim, name="hist_q"),
                "scaling": grouped_var(scaling, bdims, bcoords, gi, name="scaling", attrs={"standard_name": "Scaling factor"}),
            }
        )
        if hist_q_raw is not None:
            ds["hist_q_raw"] = grouped_var(hist_q_raw, bdims, bcoords, gi, qdim, name="hist_q_raw")
        if adapt_freq_thresh is not None:
            _add_preprocess_vars(ds, (P0_ref, P0_hist, pth), bdims, bcoords, gi)

        return ds, {
            "group": group,
            "kind": kind,
            "adapt_freq_thresh": adapt_freq_thresh,
            "max_tail_factor": max_tail_factor,
        }

    def _adjust(
        self,
        sim: DataArray,
        interp: str = "nearest",
        extrapolation: str = "constant",
        detrend: int | BaseDetrend = 1,
        mode: str = "blend",
    ):
        group: Grouper = self.group
        gi = group.indexes(sim.time)
        sima, _, _ = to_compute(sim)
        sima = _adjust_preprocess(self, sima, sim, gi)

        scaled_da = scen_like(sim, _scaled(sima, self.ds["scaling"].data, gi, interp, self.kind))
        scaled_da.attrs["units"] = sim.units
        detrending = PolyDetrend(degree=detrend, kind=self.kind, group=group) if isinstance(detrend, int) else detrend
        detrending = detrending.fit(scaled_da)
        deta, _, _ = to_compute(detrending.detrend(scaled_da))

        hist_q = as_tensor(self.ds["hist_q"].data, device=deta.device)
        af = as_tensor(self.ds["af"].data, device=deta.device)
        if _use_reference_interp(mode, gi):
            scen = apply_correction(deta, _reference_af_lookup(deta, hist_q, af, gi, interp, extrapolation), self.kind)
        else:
            scen = _algos.qm_adjust_core(
                deta, hist_q, af, device_brackets(gi, interp, deta.device),
                kind=self.kind, interp=interp, extrapolation=extrapolation,
                tables_compact=True,  # trained tables: ascending, NaN rows whole
            )
        scen = detrending.retrend(scen_like(sim, scen))
        scena = _apply_max_tail_mask(self, sima, to_compute(scen)[0], gi, interp)

        out = Dataset({"scen": scen_like(sim, scena), "trend": detrending.ds["trend"]})
        if get_option(EXTRA_OUTPUT):
            return out
        return out["scen"]
