"""Adjustment model families ported so far (the public API surface)."""

from .base import Adjust, BaseAdjustment, TrainAdjust
from .eqm import EmpiricalQuantileMapping, QuantileDeltaMapping

__all__ = [
    "Adjust",
    "BaseAdjustment",
    "EmpiricalQuantileMapping",
    "QuantileDeltaMapping",
    "TrainAdjust",
]
