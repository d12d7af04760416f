"""The reference's ``xsdba.typing`` import path."""

from .utils.typing import (  # noqa: F401
    KIND_ANNOTATION,
    DateStr,
    DayOfYearStr,
    InputKind,
    Quantified,
)
