"""Public typing helpers (reference ``typing.py``)."""

from __future__ import annotations

from enum import IntEnum
from typing import NewType, Union

from .container import DataArray
from .units import Quantity

__all__ = ["KIND_ANNOTATION", "DateStr", "DayOfYearStr", "InputKind", "Quantified"]

#: A physical quantity: a DataArray, a "1 mm d-1"-style string, or a Quantity.
Quantified = Union[DataArray, str, Quantity]

#: An ISO date string, "YYYY-MM-DD" (reference typing.py:16).
DateStr = NewType("DateStr", str)

#: A day-of-year string, "MM-DD" (reference typing.py:19).
DayOfYearStr = NewType("DayOfYearStr", str)


class InputKind(IntEnum):
    """Constants for descriptions of the nature of inputs
    (reference typing.py:26-117)."""

    VARIABLE = 0
    OPTIONAL_VARIABLE = 1
    QUANTIFIED = 2
    FREQ_STR = 3
    NUMBER = 4
    STRING = 5
    DAY_OF_YEAR = 6
    DATE = 7
    NUMBER_SEQUENCE = 8
    BOOL = 9
    DICT = 10
    KWARGS = 50
    DATASET = 70
    OTHER_PARAMETER = 99


#: Human-readable docstring annotation per input kind (reference
#: typing.py:119-135), used when rendering indicator parameter docs.
#: The annotation TEXT is the reference's contract verbatim; the table is
#: keyed by member name and resolved through the enum.
_KIND_TEXT = (
    ("VARIABLE", "str or DataArray"),
    ("OPTIONAL_VARIABLE", "str or DataArray, optional"),
    ("QUANTIFIED", "quantity (string or DataArray, with units)"),
    ("FREQ_STR", "offset alias (string)"),
    ("NUMBER", "number"),
    ("NUMBER_SEQUENCE", "number or sequence of numbers"),
    ("STRING", "str"),
    ("DAY_OF_YEAR", "date (string, MM-DD)"),
    ("DATE", "date (string, YYYY-MM-DD)"),
    ("BOOL", "boolean"),
    ("DICT", "dict"),
    ("DATASET", "Dataset, optional"),
    ("KWARGS", ""),
    ("OTHER_PARAMETER", "Any"),
)

KIND_ANNOTATION = {InputKind[name]: text for name, text in _KIND_TEXT}
