"""The reference's ``xsdba.units`` import path, with a stand-in for its
module-level pint registry."""

from .utils.units import (  # noqa: F401
    DELTA_ABSOLUTE_TEMP,
    FREQ_UNITS,
    Quantity,
    Unit,
    convert_units_to,
    extract_units,
    harmonize_units,
    infer_sampling_units,
    parse_units,
    pint2cfattrs,
    pint_multiply,
    str2pint,
    str2quantity,
    units2pint,
    units2str,
)


class _Registry:
    """Stand-in for the reference's module-level pint application registry
    (``units.py:34``).  The port's dimensional engine has no global registry
    object; this facade covers the registry surface users touch:
    ``units("1 mm/d")``, ``units.parse_units``, ``units.parse_expression``,
    ``units.Quantity`` and ``units.Unit``.
    """

    Quantity = Quantity
    Unit = Unit

    @staticmethod
    def parse_units(s):
        return parse_units(s)

    @staticmethod
    def parse_expression(s):
        return str2quantity(s)

    def __call__(self, s):
        return str2quantity(s)


units = _Registry()
