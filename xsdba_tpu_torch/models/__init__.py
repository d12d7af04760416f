"""Adjustment model families: the eleven train/adjust classes of the JAX
package and its SBCK gateway (the public API surface)."""

from .base import Adjust, BaseAdjustment, TrainAdjust
from .dqm import DetrendedQuantileMapping
from .eqm import EmpiricalQuantileMapping, QuantileDeltaMapping
from .extremes import ExtremeValues
from .mbcn import MBCn, NpdfTransform
from .otc import OTC, dOTC
from .pca import PrincipalComponents
from .sbck import generate_sbck_classes
from .scaling import LOCI, Scaling

__all__ = [
    "LOCI",
    "OTC",
    "Adjust",
    "BaseAdjustment",
    "DetrendedQuantileMapping",
    "EmpiricalQuantileMapping",
    "ExtremeValues",
    "MBCn",
    "NpdfTransform",
    "PrincipalComponents",
    "QuantileDeltaMapping",
    "Scaling",
    "TrainAdjust",
    "dOTC",
    "generate_sbck_classes",
]
