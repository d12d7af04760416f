"""Adjustment model families ported so far (the public API surface)."""

from .base import Adjust, BaseAdjustment, TrainAdjust
from .dqm import DetrendedQuantileMapping
from .eqm import EmpiricalQuantileMapping, QuantileDeltaMapping
from .mbcn import MBCn, NpdfTransform
from .scaling import LOCI, Scaling

__all__ = [
    "LOCI",
    "Adjust",
    "BaseAdjustment",
    "DetrendedQuantileMapping",
    "EmpiricalQuantileMapping",
    "MBCn",
    "NpdfTransform",
    "QuantileDeltaMapping",
    "Scaling",
    "TrainAdjust",
]
