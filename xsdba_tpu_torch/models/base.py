"""Train/adjust scheme base classes.

Mirrors the reference's public machinery (``adjustment.py:68-411``): input
checks, unit harmonization, history/metadata stamping, and the
``TrainAdjust`` (train -> object -> adjust) / ``Adjust`` (one-shot) schemes.
The compute itself is dispatched to tensor cores over dense ``[..., time]``
tensors (see ``models/_algos.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..utils.container import DataArray, Dataset
from ..utils.formatting import gen_call_string, update_history
from ..utils.grouper import Grouper
from ..utils.options import AS_DATASET, EXTRA_OUTPUT, get_option
from ..utils.params import ParametrizableWithDataset
from ..utils.units import harmonize_units

__all__ = ["Adjust", "BaseAdjustment", "TrainAdjust"]


def _normalize_group_kwarg(kwargs: dict) -> dict:
    """Fold string ``group`` + ``window``/``add_dims`` kwargs into a single
    Grouper (reference ``Grouper.from_kwargs``, base.py:179-186)."""
    if isinstance(kwargs.get("group"), str):
        kwargs["group"] = Grouper(
            kwargs["group"],
            window=kwargs.pop("window", 1),
            add_dims=kwargs.pop("add_dims", None),
        )
    return kwargs


def _package_output(raw, source: DataArray, call_str: str, units: str | None):
    """Contractual output form shared by both schemes: a ``scen`` DataArray
    carrying the source attrs, a timestamped CF ``history`` line and the
    ``bias_adjustment`` marker (reference adjustment.py:295-316, 395-409) —
    or the full / one-variable Dataset under the ``extra_output`` /
    ``as_dataset`` options."""
    ds = Dataset({"scen": raw.rename("scen")}) if isinstance(raw, DataArray) else raw
    scen: DataArray = ds["scen"]
    scen.attrs.update(source.attrs)
    scen.attrs["history"] = update_history(f"Bias-adjusted with {call_str}", source)
    scen.attrs["bias_adjustment"] = call_str
    if units is not None and "multivar" not in source.coords:
        scen.attrs["units"] = units
    if get_option(EXTRA_OUTPUT):
        return ds
    if get_option(AS_DATASET):
        return Dataset({"scen": scen})
    return scen


class BaseAdjustment(ParametrizableWithDataset):
    """Input validation + unit harmonization shared by all schemes
    (reference adjustment.py:68-206)."""

    _allow_diff_calendars = True
    _allow_diff_training_times = True
    _allow_diff_time_sizes = True
    _attribute = "_xsdba_adjustment"

    @classmethod
    def _check_inputs(cls, *inputs: DataArray, group: Grouper | str | None = None):
        group = Grouper(group) if isinstance(group, str) else group
        calendars = {da.time.calendar for da in inputs if da.time is not None}
        if not cls._allow_diff_calendars and len(calendars) > 1:
            raise ValueError(f"Inputs are defined on different calendars: {sorted(calendars)}.")
        if group is not None and group.prop == "dayofyear" and "standard" in calendars:
            import warnings

            warnings.warn(
                "Using dayofyear grouping on a standard calendar: day-of-year 366 "
                "only exists on leap years and will be poorly sampled.",
                stacklevel=3,
            )
        # multivariate coordinate must match
        mv = [np.asarray(da.coords["multivar"]) for da in inputs if "multivar" in da.coords]
        if mv and not all(np.array_equal(mv[0], m) for m in mv[1:]):
            raise ValueError("The multivariate coordinates of the inputs do not match.")

    @classmethod
    def _check_matching_times(cls, ref: DataArray, hist: DataArray):
        if ref.time != hist.time:
            raise ValueError("`ref` and `hist` have distinct time arrays, this is not supported for this adjustment.")

    @classmethod
    def _check_matching_time_sizes(cls, *inputs: DataArray):
        t0 = inputs[0].sizes["time"]
        if any(da.sizes["time"] != t0 for da in inputs[1:]):
            raise ValueError("Inputs have different time sizes, this is not supported for this adjustment.")

    @classmethod
    def _harmonize_units(cls, *inputs: DataArray, target: str | None = None):
        return harmonize_units(*inputs, target=target)

    def __repr__(self):
        shown = {
            k: v
            for k, v in self.items()
            if k not in ("hist_calendar", "train_units", "_trained") and not k.startswith("_")
        }
        params = ", ".join(f"{k}={v!r}" for k, v in shown.items())
        return f"{self.__class__.__name__}({params})"


class TrainAdjust(BaseAdjustment):
    """Two-step scheme: ``cls.train(ref, hist, **kw)`` then ``obj.adjust(sim)``
    (reference adjustment.py:209-332)."""

    _allow_diff_calendars = True

    @classmethod
    def train(cls, ref: DataArray, hist: DataArray, **kwargs) -> "TrainAdjust":
        validate = not kwargs.pop("skip_input_checks", False)
        kwargs = _normalize_group_kwarg(kwargs)
        units = ref.units
        if validate:
            cls._check_inputs(ref, hist, group=kwargs.get("group"))
            (ref, hist), units = cls._harmonize_units(ref, hist)

        if not cls._allow_diff_training_times:
            cls._check_matching_times(ref, hist)
        elif not cls._allow_diff_time_sizes:
            cls._check_matching_time_sizes(ref, hist)
            hist = hist.copy()
            hist.coords["time"] = ref.time

        ds, params = cls._train(ref, hist, **kwargs)
        obj = cls(
            _trained=True,
            hist_calendar=hist.time.calendar if hist.time is not None else "standard",
            train_units=units,
            **params,
        )
        obj.set_dataset(ds)
        return obj

    def adjust(self, sim: DataArray, *args, **kwargs):
        validate = not kwargs.pop("skip_input_checks", False)
        if validate:
            if "group" in self:
                self._check_inputs(sim, *args, group=self.group)
            (sim, *args), _ = self._harmonize_units(sim, *args, target=self.train_units)

        raw = self._adjust(sim, *args, **kwargs)
        call_str = f"{self!s}.adjust(sim, {gen_call_string('', **kwargs)[1:-1]})"
        return _package_output(raw, sim, call_str, self.train_units)

    def set_dataset(self, ds: Dataset):
        super().set_dataset(ds)
        self.ds.attrs["adj_params"] = str(self)

    @classmethod
    def _train(cls, ref: DataArray, hist: DataArray, **kwargs) -> tuple[Dataset, dict[str, Any]]:
        raise NotImplementedError

    def _adjust(self, sim: DataArray, *args, **kwargs):
        raise NotImplementedError


class Adjust(BaseAdjustment):
    """One-shot scheme: ``cls.adjust(ref, hist, sim, **kw)``
    (reference adjustment.py:335-411)."""

    @classmethod
    def adjust(cls, ref: DataArray, hist: DataArray, sim: DataArray | None = None, **kwargs):
        kwargs = _normalize_group_kwarg(dict(kwargs))
        validate = not kwargs.pop("skip_input_checks", False)

        if sim is None:
            # reference adjustment.py:370-372: sim defaults to hist, marked.
            sim = hist.copy()
            sim.attrs["_is_hist"] = True

        if validate:
            if "group" in kwargs:
                cls._check_inputs(ref, hist, sim, group=kwargs["group"])
            (ref, hist, sim), _ = cls._harmonize_units(ref, hist, sim)

        if not cls._allow_diff_time_sizes:
            cls._check_matching_time_sizes(ref, hist, sim)
        if not cls._allow_diff_training_times:
            cls._check_matching_times(ref, hist)

        raw = cls._adjust(ref, hist, sim, **kwargs)
        params = ", ".join(f"{k}={v!r}" for k, v in kwargs.items())
        call_str = f"{cls.__name__}.adjust(ref, hist, sim, {params})"
        return _package_output(raw, sim, call_str, ref.units)

    @classmethod
    def _adjust(cls, ref, hist, sim, **kwargs):
        raise NotImplementedError
