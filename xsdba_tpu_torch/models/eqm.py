"""Empirical Quantile Mapping and Quantile Delta Mapping.

Port of reference ``adjustment.py:414-528`` (EQM) and ``:674-742`` (QDM):
train is one gather->sort->lerp over static group indexes; adjust is one
table lookup + correction.  Everything runs on the device of the data it is
given; trained parameters follow the data they adjust.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from ..ops.correction import ADDITIVE, apply_correction, equally_spaced_nodes
from ..ops.segment import gather_groups
from ..processing import _adapt_freq_apply_core, _adapt_freq_grouped, _jitter_core
from ..utils.container import DataArray, Dataset
from ..utils.grouper import Grouper
from ..utils.tensor import as_tensor, numpy_dtype, to_numpy, upload
from ..utils.units import convert_units_to
from . import _algos
from ._wrap import device_brackets, grouped_var, scen_like, to_compute, training_tensors
from .base import TrainAdjust

__all__ = ["EmpiricalQuantileMapping", "QuantileDeltaMapping"]

_AF_ATTRS = {"standard_name": "Adjustment factors", "long_name": "Quantile mapping adjustment factors"}
_HIST_Q_ATTRS = {"standard_name": "Model quantiles", "long_name": "Quantiles of model on the reference period, after preprocess"}


class EmpiricalQuantileMapping(TrainAdjust):
    r"""Empirical Quantile Mapping: :math:`F^{-1}_{ref}(F_{hist}(sim))`.

    Train computes per-group quantiles of ``ref`` and ``hist`` and adjustment
    factors between them; adjust interpolates the factors at each sim value.
    Parameters and behavior mirror reference ``adjustment.py:414-528``:
    ``nquantiles`` (int -> bin-midpoint nodes), ``kind`` (+/*), ``group``,
    ``max_tail_factor``; adjust takes ``interp`` (nearest/linear/cubic) and
    ``extrapolation`` (constant/nan).  A windowed dayofyear or "5D" group
    trains through the counting-selection engine (``ops/selquant.py``; the
    CPU's default, and on a GPU under ``set_options(selection_on_tpu=True)``,
    with the row sort kernel of ``ops/sort.py``) or the merge engine
    (``ops/quantile.py``, with the CUDA kernels of ``ops/merge.py``; the
    GPU's default).  Numpy data runs on the ``device`` option's device (CUDA
    unless the caller asks for the CPU).  Training takes the dry-day
    preprocessing (``adapt_freq_thresh``, jitter under or over a threshold),
    and an object trained with ``adapt_freq_thresh`` adapts sim's dry-day
    frequency before adjusting it.  Cubic interpolation evaluates the
    not-a-knot spline of each group's table in plain PyTorch (no kernel
    serves it, in either package).
    """

    _allow_diff_calendars = False
    _allow_diff_training_times = False
    _af_long_name = _AF_ATTRS["long_name"]

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
        if np.isscalar(nquantiles):
            quantiles = equally_spaced_nodes(int(nquantiles))
        else:
            quantiles = np.asarray(nquantiles)
        refa, hista, bdims, bcoords, gi, gi_t = training_tensors(group, ref, hist)
        quantiles = quantiles.astype(numpy_dtype(refa.dtype))
        q_t = upload(quantiles, device=refa.device)
        gather_idx = upload(gi_t.gather_idx, device=refa.device)

        hist_q_raw = None
        if max_tail_factor is not None:
            # quantiles of hist before preprocessing (reference _adjustment.py:146-149)
            from ..ops.quantile import grouped_nan_quantile

            hist_q_raw = grouped_nan_quantile(hista, gather_idx, q_t)
        hista = _apply_jitter(hista, hist, jitter_under_thresh_value, jitter_over_thresh_value, jitter_over_thresh_upper_bnd)
        if adapt_freq_thresh is not None:
            refg, histg, P0_ref, P0_hist, pth = _preprocess(refa, hista, gi_t, hist, adapt_freq_thresh)
            af, hist_q = _algos.eqm_train_core(refg, histg, q_t, kind=kind)
        elif gi_t.merge_plan is not None:
            # windowed doy/5D groupings: the merge engine sorts each window-1
            # list once instead of the window-fold amplified gather
            af, hist_q = _algos.eqm_train_windowed(refa, hista, gi_t.merge_plan, q_t, kind=kind)
        else:
            # memory-bounded path: no full [..., G, L] gather materialized
            af, hist_q = _algos.eqm_train_from_raw(refa, hista, gather_idx, q_t, kind=kind)

        qdim = ("quantiles", quantiles)
        ds = Dataset(
            {
                "af": grouped_var(af, bdims, bcoords, gi, qdim, name="af", attrs=dict(_AF_ATTRS)),
                "hist_q": grouped_var(hist_q, bdims, bcoords, gi, qdim, name="hist_q", attrs=dict(_HIST_Q_ATTRS)),
            }
        )
        if hist_q_raw is not None:
            ds["hist_q_raw"] = grouped_var(hist_q_raw, bdims, bcoords, gi, qdim, name="hist_q_raw", attrs={"standard_name": "Model quantiles", "long_name": "Quantiles of model on the reference period, before preprocess"})
        if adapt_freq_thresh is not None:
            _add_preprocess_vars(ds, (P0_ref, P0_hist, pth), bdims, bcoords, gi)

        return ds, {
            "group": group,
            "kind": kind,
            "adapt_freq_thresh": adapt_freq_thresh,
            "max_tail_factor": max_tail_factor,
        }

    @classmethod
    def from_params(
        cls,
        af,
        hist_q,
        quantiles,
        group: str | Grouper = "time",
        kind: str = ADDITIVE,
        *,
        train_units: str | None = None,
    ) -> "EmpiricalQuantileMapping":
        """A trained object from its parameters: ``af`` and ``hist_q``
        [..., G, nq] (numpy arrays or tensors), the ``quantiles`` [nq] they
        were trained at, the grouping and the kind.  ``train_units`` are the
        units the tables were trained in; sim is converted to them at adjust
        time (left as it comes when None).  The leading dims are named
        ``dim_0``, ``dim_1``, ..."""
        group = Grouper(group) if isinstance(group, str) else group
        af_np = to_numpy(af)
        G = af_np.shape[-2]
        batch_dims = tuple(f"dim_{i}" for i in range(af_np.ndim - 2))
        prop = "group" if group.prop == "group" else group.prop
        coord = np.arange(1, G + 1) if group.prop == "dayofyear" else group.get_coordinate()
        dims = tuple(batch_dims) + (prop, "quantiles")
        coords = {prop: coord, "quantiles": np.asarray(quantiles)}
        af_attrs = dict(_AF_ATTRS, long_name=cls._af_long_name)
        ds = Dataset(
            {
                "af": DataArray(af, dims, dict(coords), af_attrs, "af"),
                "hist_q": DataArray(hist_q, dims, dict(coords), dict(_HIST_Q_ATTRS), "hist_q"),
            }
        )
        obj = cls(
            _trained=True,
            hist_calendar=None,
            train_units=train_units,
            group=group,
            kind=kind,
            adapt_freq_thresh=None,
            max_tail_factor=None,
        )
        obj.set_dataset(ds)
        return obj

    def _adjust(self, sim: DataArray, interp: str = "nearest", extrapolation: str = "constant", mode: str = "blend"):
        group: Grouper = self.group
        gi = group.indexes(sim.time)
        sima, _, _ = to_compute(sim)
        sima = _adjust_preprocess(self, sima, sim, gi)

        hist_q = as_tensor(self.ds["hist_q"].data, device=sima.device)
        af = as_tensor(self.ds["af"].data, device=sima.device)

        if _use_reference_interp(mode, gi):
            af_t = _reference_af_lookup(sima, hist_q, af, gi, interp, extrapolation)
            scen = apply_correction(sima, af_t, self.kind)
        else:
            scen = _algos.qm_adjust_core(
                sima,
                hist_q,
                af,
                device_brackets(gi, interp, sima.device),
                kind=self.kind,
                interp=interp,
                extrapolation=extrapolation,
                tables_compact=True,  # trained tables: ascending, NaN rows whole
            )
        scen = _apply_max_tail_mask(self, sima, scen, gi, interp)
        return scen_like(sim, scen)


class QuantileDeltaMapping(EmpiricalQuantileMapping):
    r"""Quantile Delta Mapping (reference ``adjustment.py:674-742``).

    Same training as EQM; adjust ranks each sim value within its group
    (percentile), looks the factors up at that percentile and applies them —
    preserving the simulated change signal per quantile.
    """

    _af_long_name = "Quantile delta mapping adjustment factors"

    @classmethod
    def _train(cls, ref, hist, **kwargs):
        ds, params = super()._train(ref, hist, **kwargs)
        ds["af"].attrs["long_name"] = cls._af_long_name
        return ds, params

    def _adjust(
        self,
        sim: DataArray,
        interp: str = "nearest",
        extrapolation: str = "constant",
        rank_window: bool | None = None,
        mode: str = "blend",
    ):
        group: Grouper = self.group
        gi = group.indexes(sim.time)
        # rank over the full training window or only group members
        # (reference _adjustment.py:858-872: window ranking is the new default
        # path when `rank_window` is set).
        if rank_window is None and group.window > 1:
            # reference _adjustment.py:858-871: unset rank_window on a
            # windowed group warns that windowed ranking becomes the only
            # behaviour in xsdba>=0.8
            warnings.warn(
                "QDM method can now perform the adjustment step by expanding "
                "the time dimension with the same window as used in the "
                "training. This can already be used by setting "
                "`rank_window = True`. This will be the only possible "
                "behaviour in `xsdba>=0.8`. The current behaviour is obtained "
                "by setting `rank_window = False` and will be deprecated in "
                "`xsdba>=0.8`.",
                category=DeprecationWarning,
                stacklevel=2,
            )
        gi_rank = gi if rank_window else Grouper(group.name).indexes(sim.time)
        sima, _, _ = to_compute(sim)
        sima = _adjust_preprocess(self, sima, sim, gi)
        dev = sima.device

        af = as_tensor(self.ds["af"].data, device=dev)
        quantiles = upload(np.asarray(self.ds["af"].coords["quantiles"]), dtype=sima.dtype, device=dev)
        gather_idx = upload(gi_rank.gather_idx, device=dev)
        group_idx = upload(gi_rank.group_idx, device=dev)
        scatter_slot = upload(gi_rank.scatter_slot, device=dev)

        if _use_reference_interp(mode, gi):
            # reference mode consumes only the rank step from the device, then
            # does the exact AF lookup on host — the shared quantile nodes act
            # as each group's xq (reference _adjustment.py:874-880 +
            # utils.py:466-480)
            from ..ops.segment import grouped_rank

            sim_q = grouped_rank(sima, gather_idx, group_idx, scatter_slot, pct=True)
            G = len(gi.positions)
            q64 = to_numpy(quantiles).astype(np.float64)
            xq = np.broadcast_to(q64, (G, q64.shape[0]))
            af_t = _reference_af_lookup(sim_q, xq, af, gi, interp, extrapolation)
            scen = apply_correction(sima, af_t, self.kind)
        else:
            scen, sim_q = _algos.qdm_adjust_core(
                sima,
                af,
                quantiles,
                device_brackets(gi, interp, dev),
                gather_idx,
                group_idx,
                scatter_slot,
                kind=self.kind,
                interp=interp,
                extrapolation=extrapolation,
            )
        scen = _apply_max_tail_mask(self, sima, scen, gi, interp)
        out = Dataset({"scen": scen_like(sim, scen), "sim_q": scen_like(sim, sim_q, name="sim_q")})
        from ..utils.options import EXTRA_OUTPUT, get_option

        if get_option(EXTRA_OUTPUT):
            return out
        return out["scen"]


def _apply_jitter(hista, hist_da, jitter_under_thresh_value, jitter_over_thresh_value, jitter_over_thresh_upper_bnd):
    """Optional jitter preprocessing of hist (reference _adjustment.py:55-68)."""
    if (jitter_over_thresh_value is None) ^ (jitter_over_thresh_upper_bnd is None):
        raise ValueError(
            "`jitter_over_thresh_value` and `jitter_over_thresh_upper_bnd` must both "
            "be specified or both be `None`."
        )
    if jitter_under_thresh_value or jitter_over_thresh_value:
        lower = convert_units_to(jitter_under_thresh_value, hist_da.units) if jitter_under_thresh_value else None
        upper = convert_units_to(jitter_over_thresh_value, hist_da.units) if jitter_over_thresh_value else None
        bnd = convert_units_to(jitter_over_thresh_upper_bnd, hist_da.units) if jitter_over_thresh_value else None
        hista = _jitter_core(hista, lower, upper, bnd)
    return hista


def _preprocess(refa, hista, gi, hist_da, adapt_freq_thresh):
    """Training-time frequency adaptation (reference ``_adjustment.py:32-83``;
    jitter is :func:`_apply_jitter`, applied before): returns the gathered
    (refg, adapted histg) and the per-group P0_ref, P0_hist and pth."""
    refg = gather_groups(refa, gi.gather_idx)
    histg = gather_groups(hista, gi.gather_idx)
    thresh = convert_units_to(adapt_freq_thresh, hist_da.units)
    histg_ad, P0_ref, P0_hist, pth, _ = _adapt_freq_grouped(refg, histg, thresh)
    return refg, histg_ad, P0_ref, P0_hist, pth


def _add_preprocess_vars(ds, values, bdims, bcoords, gi):
    """The trained P0_ref, P0_hist and pth of ``adapt_freq_thresh``."""
    for name, v in zip(("P0_ref", "P0_hist", "pth"), values):
        ds[name] = grouped_var(v, bdims, bcoords, gi, name=name)


def _adjust_preprocess(obj, sima, sim_da, gi):
    """Adjust-time frequency adaptation of sim with the trained P0 and pth
    (reference ``_adjustment.py:639-645``), over the grouping without its
    window, as the reference re-runs adapt_freq on sim."""
    if obj.get("adapt_freq_thresh") is None:
        return sima
    thresh = convert_units_to(obj.adapt_freq_thresh, obj.train_units)
    gi_time = Grouper(obj.group.name).indexes(sim_da.time)
    P0_ref, P0_hist, pth = (as_tensor(obj.ds[k].data, device=sima.device) for k in ("P0_ref", "P0_hist", "pth"))
    return _adapt_freq_apply_core(sima, gi_time, thresh, P0_ref, P0_hist, pth)


def _use_reference_interp(mode: str, gi) -> bool:
    """True when the exact reference-parity grouped lookup should run.

    ``mode="blend"`` is the device path (separable cyclic blend);
    ``mode="reference"`` evaluates the reference's scipy-griddata
    triangulation on host (utils.py:380-400) — parity runs, not perf runs.
    The ungrouped 1-D path is already bit-faithful, so "reference" only
    changes behavior for grouped configs."""
    if mode not in ("blend", "reference"):
        raise ValueError(f"Unknown interpolation mode {mode!r} (blend, reference).")
    return mode == "reference" and gi.prop != "group"


def _reference_af_lookup(values, xq, yq, gi, interp, extrapolation):
    """Host exact grouped AF lookup at ``values`` (float64 throughout);
    returned on the values' device in their dtype."""
    from ..ops.interp import interp_on_quantiles_reference

    newg = gi.frac_idx if interp != "nearest" else gi.positions[gi.group_idx]
    out = interp_on_quantiles_reference(
        to_numpy(values).astype(np.float64),
        newg,
        to_numpy(xq).astype(np.float64),
        to_numpy(yq).astype(np.float64),
        gi.positions,
        method=interp,
        extrap=extrapolation,
    )
    return torch.as_tensor(out, dtype=values.dtype, device=values.device)


def _apply_max_tail_mask(obj, sima, scen, gi, interp):
    """Skip adjustment where sim exceeds ``max_tail_factor`` times the last raw
    hist quantile (reference ``_adjustment.py:647-673``)."""
    if obj.get("max_tail_factor") is None:
        return scen
    last_q = as_tensor(obj.ds["hist_q_raw"].data, device=sima.device)[..., -1]
    interp_b = interp if gi.prop != "dayofyear" else "nearest"
    last_q_t = _algos.broadcast_groups_core(last_q, device_brackets(gi, interp_b, sima.device))
    mask = sima > obj.max_tail_factor * last_q_t
    return torch.where(mask, sima, scen)
