"""The reference's ``xsdba.adjustment`` import path: the train/adjust
classes and the SBCK gateway."""

from .models import (  # noqa: F401
    LOCI,
    OTC,
    Adjust,
    BaseAdjustment,
    DetrendedQuantileMapping,
    EmpiricalQuantileMapping,
    ExtremeValues,
    MBCn,
    NpdfTransform,
    PrincipalComponents,
    QuantileDeltaMapping,
    Scaling,
    TrainAdjust,
    dOTC,
)
from .models.sbck import generate_sbck_classes  # noqa: F401
