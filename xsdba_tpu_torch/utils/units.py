"""Minimal CF-units engine (pint-free).

The reference uses a pint application registry + cf-xarray formatting
(``units.py:34-201,297-421``).  pint is not available here, so this module
implements the subset of dimensional analysis bias adjustment actually needs:

- parsing CF-style unit strings ("K", "degC", "mm d-1", "kg m-2 s-1", "%", ...),
- conversion between commensurable units, incl. temperature offsets and the
  hydrology equivalence 1 kg m-2 == 1 mm of water,
- ``convert_units_to`` / ``harmonize_units`` / ``units2str`` analogues,
- quantity strings ("1 mm/d") for thresholds (reference ``typing.py:22``
  ``Quantified``).

Conversions happen on host metadata or as a single scalar multiply on the
data, on whatever device it lies — never a per-element host loop.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

__all__ = [
    "DELTA_ABSOLUTE_TEMP",
    "FREQ_UNITS",
    "Quantity",
    "Unit",
    "convert_units_to",
    "extract_units",
    "harmonize_units",
    "infer_sampling_units",
    "parse_units",
    "str2quantity",
    "units2str",
]


# Base dimensions: (length, mass, time, temperature)
_DIMLESS = (0, 0, 0, 0)


def _dims(length=0, mass=0, time=0, temp=0):
    return (length, mass, time, temp)


# name -> (scale_to_SI, dims, offset_to_SI)   offset only for pure temperature
_UNITS: dict[str, tuple[float, tuple, float]] = {}


def _def(names, scale, dims, offset=0.0):
    for n in names:
        _UNITS[n] = (scale, dims, offset)


_def(["m", "meter", "metre", "meters"], 1.0, _dims(length=1))
_def(["cm", "centimeter"], 0.01, _dims(length=1))
_def(["mm", "millimeter", "millimetre"], 0.001, _dims(length=1))
_def(["km", "kilometer"], 1000.0, _dims(length=1))
_def(["kg", "kilogram"], 1.0, _dims(mass=1))
_def(["g", "gram"], 0.001, _dims(mass=1))
_def(["s", "sec", "second", "seconds"], 1.0, _dims(time=1))
_def(["min", "minute", "minutes"], 60.0, _dims(time=1))
_def(["h", "hr", "hour", "hours"], 3600.0, _dims(time=1))
_def(["d", "day", "days"], 86400.0, _dims(time=1))
_def(["week", "weeks"], 7 * 86400.0, _dims(time=1))
_def(["month", "months", "mon"], 30.436875 * 86400.0, _dims(time=1))
_def(["year", "years", "yr", "a", "annum"], 365.2425 * 86400.0, _dims(time=1))
_def(["K", "kelvin", "degK"], 1.0, _dims(temp=1))
_def(["degC", "C", "celsius", "°C"], 1.0, _dims(temp=1), offset=273.15)
_def(["degF", "°F", "fahrenheit"], 5.0 / 9.0, _dims(temp=1), offset=459.67 * 5.0 / 9.0)
_def(["delta_degC"], 1.0, _dims(temp=1))
_def(["delta_degF"], 5.0 / 9.0, _dims(temp=1))
_def(["degR", "rankine"], 5.0 / 9.0, _dims(temp=1))
_def(["Pa", "pascal"], 1.0, _dims(length=-1, mass=1, time=-2))
_def(["hPa", "mbar", "millibar"], 100.0, _dims(length=-1, mass=1, time=-2))
_def(["W"], 1.0, _dims(length=2, mass=1, time=-3))
_def(["J"], 1.0, _dims(length=2, mass=1, time=-2))
_def(["%", "percent", "pct"], 0.01, _DIMLESS)
_def(["1", "", "dimensionless", "count"], 1.0, _DIMLESS)


@dataclass(frozen=True)
class Unit:
    scale: float
    dims: tuple
    offset: float = 0.0
    raw: str = ""

    @property
    def is_temperature(self) -> bool:
        return self.dims == _dims(temp=1)

    def __str__(self):
        return self.raw


@dataclass(frozen=True)
class Quantity:
    """A magnitude with a Unit.  Accepts the pint constructor forms reference
    users rely on: ``Quantity(3, "degC")``, ``Quantity("3 degC")`` and bare
    ``Quantity(3)`` (dimensionless)."""

    magnitude: float
    units: Unit = None

    def __post_init__(self):
        mag, un = self.magnitude, self.units
        if un is None:
            if isinstance(mag, str):
                q = str2quantity(mag)
                mag, un = q.magnitude, q.units
            else:
                un = parse_units("")
        elif not isinstance(un, Unit):
            un = parse_units(un)
        object.__setattr__(self, "magnitude", mag)
        object.__setattr__(self, "units", un)

    def to(self, target: "Unit | str") -> "Quantity":
        tgt = parse_units(target) if isinstance(target, str) else target
        return Quantity(_convert_scalar(self.magnitude, self.units, tgt), tgt)


_TOKEN_RE = re.compile(r"([A-Za-z°%µ]+)(?:\s*\^|\s*\*\*)?\s*(-?\d+(?:/\d+)?)?")


def parse_units(s) -> Unit:
    """Parse a CF unit string ("mm d-1", "kg m-2 s-1", "mm/day", "degC")."""
    if isinstance(s, Unit):
        return s
    raw = str(s).strip()
    if raw in _UNITS:
        sc, dims, off = _UNITS[raw]
        return Unit(sc, dims, off, raw)
    # split numerator/denominator on '/'
    parts = raw.split("/")
    scale = 1.0
    dims = [0, 0, 0, 0]
    for pi, part in enumerate(parts):
        sign = 1 if pi == 0 else -1
        for m in _TOKEN_RE.finditer(part):
            name, exp = m.group(1), m.group(2)
            if name not in _UNITS:
                raise ValueError(f"Unknown unit {name!r} in {raw!r}")
            e = Fraction(exp) if exp else Fraction(1)
            e *= sign
            usc, udims, uoff = _UNITS[name]
            if uoff != 0 and (e != 1 or len(parts) > 1 or len(list(_TOKEN_RE.finditer(part))) > 1):
                # offset units only stand alone
                uoff = 0.0
            scale *= float(usc) ** float(e)
            for i in range(4):
                dims[i] += udims[i] * e
    offset = 0.0
    first = raw.split()[0] if raw.split() else raw
    if raw in ("degC", "C", "celsius", "°C", "degF", "°F", "fahrenheit") or (
        first in _UNITS and _UNITS[first][2] != 0 and raw == first
    ):
        offset = _UNITS[first][2]
    return Unit(scale, tuple(dims), offset, raw)


_QTY_RE = re.compile(r"^\s*(-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)\s*(.*)$")


def str2quantity(s) -> Quantity:
    """Parse "1 mm d-1"-style quantity strings (reference units.py:120-201)."""
    if isinstance(s, Quantity):
        return s
    m = _QTY_RE.match(str(s))
    if not m:
        raise ValueError(f"Cannot parse quantity: {s!r}")
    return Quantity(float(m.group(1)), parse_units(m.group(2)))


def units2str(u) -> str:
    if isinstance(u, Unit):
        return u.raw
    return str(u)


# The hydrology identity: 1 kg of water over 1 m^2 is 1 mm deep.
# Treat mass m-2 <-> length as commensurable by folding density 1000 kg/m3.
_WATER_DENSITY = 1000.0  # kg/m3


def _water_equiv(dims: tuple) -> tuple:
    """Normalize precip dims: fold mass into length via water density
    (kg -> m^3 of water), so "kg m-2 s-1" and "mm s-1" become commensurable."""
    length, mass, time, temp = dims
    if mass != 0:
        return (length + 3 * mass, 0, time, temp)
    return dims


def _commensurable(a: Unit, b: Unit) -> tuple[bool, float]:
    """Check conversion possibility; return (ok, extra_scale a->b)."""
    if a.dims == b.dims:
        return True, 1.0
    wa, wb = _water_equiv(a.dims), _water_equiv(b.dims)
    if wa == wb:
        # density factor: each kg m-2 counts as mm; scale mass dim out
        fac = _WATER_DENSITY ** (-a.dims[1]) * _WATER_DENSITY ** (b.dims[1])
        return True, fac * 1.0
    return False, 0.0


def _convert_scalar(value, src: Unit, tgt: Unit):
    ok, extra = _commensurable(src, tgt)
    if not ok:
        raise ValueError(f"Cannot convert {src.raw!r} to {tgt.raw!r}")
    if src.is_temperature and tgt.is_temperature:
        si = np.multiply(value, src.scale) + src.offset
        return (si - tgt.offset) / tgt.scale
    return np.multiply(value, src.scale / tgt.scale * extra)


def conversion_factor(src, tgt) -> tuple[float, float]:
    """Return (scale, offset) such that x_tgt = x_src * scale + offset."""
    src = parse_units(src) if not isinstance(src, Unit) else src
    tgt = parse_units(tgt) if not isinstance(tgt, Unit) else tgt
    ok, extra = _commensurable(src, tgt)
    if not ok:
        raise ValueError(f"Cannot convert {src.raw!r} to {tgt.raw!r}")
    if src.is_temperature and tgt.is_temperature:
        scale = src.scale / tgt.scale
        offset = (src.offset - tgt.offset) / tgt.scale
        return scale, offset
    return src.scale / tgt.scale * extra, 0.0


def convert_units_to(source, target_units):
    """Convert a DataArray / Quantity / quantity-string to target units.

    Reference ``units.py:297-340``.  Returns the converted object; DataArrays
    get their ``units`` attr updated.  Scalar path for thresholds.
    """
    from .container import DataArray

    tgt_str = units2str(target_units) if not hasattr(target_units, "attrs") else target_units.attrs.get("units", "")
    tgt = parse_units(tgt_str)
    if isinstance(source, str):
        q = str2quantity(source)
        return q.to(tgt).magnitude
    if isinstance(source, Quantity):
        return source.to(tgt).magnitude
    if isinstance(source, DataArray):
        src = parse_units(source.units)
        scale, offset = conversion_factor(src, tgt)
        if scale == 1.0 and offset == 0.0:
            out = source.copy()
        else:
            out = source.copy(data=source.data * scale + offset)
        out.attrs["units"] = tgt_str
        return out
    # plain number: assume already target units
    return source


def harmonize_units(*arrays, target: str | None = None):
    """Convert all DataArrays to shared units (the first's, or ``target``).

    Analogue of the reference decorator ``units.py:373-421``; returns
    (converted_arrays, units_str).  Stacked multivariate arrays (carrying a
    ``_variable_attrs`` mapping from ``stack_variables``) are converted
    per variable along their leading multivar axis (reference
    adjustment.py:136-185 stacked-units path).
    """
    from .container import DataArray

    das = [a for a in arrays if isinstance(a, DataArray)]
    if not das:
        return list(arrays), target or ""

    if any("_variable_attrs" in a.attrs for a in das):
        # stacked target: an explicit per-variable units mapping (the
        # training units, passed back at adjust time — possibly as the JSON
        # string a save/load round-trip produced), else the first array's
        if isinstance(target, dict):
            tgt_units = dict(target)
        elif isinstance(target, str) and target.startswith("{"):
            import json as _json

            tgt_units = _json.loads(target)
        else:
            ref_attrs = das[0].attrs.get("_variable_attrs", {})
            tgt_units = {k: v.get("units", "") for k, v in ref_attrs.items()}
        out = []
        for a in arrays:
            if not isinstance(a, DataArray) or "_variable_attrs" not in a.attrs:
                out.append(a)
                continue
            names = sorted(a.attrs["_variable_attrs"])
            data = a.data
            var_attrs = {k: dict(v) for k, v in a.attrs["_variable_attrs"].items()}
            parts = []
            for i, name in enumerate(names):
                src_u = var_attrs.get(name, {}).get("units", "")
                dst_u = tgt_units.get(name, src_u)
                scale, offset = conversion_factor(src_u, dst_u) if dst_u else (1.0, 0.0)
                sl = data[i]
                parts.append(sl * scale + offset if (scale != 1.0 or offset != 0.0) else sl)
                var_attrs.setdefault(name, {})["units"] = dst_u
            stack = torch.stack if isinstance(data, torch.Tensor) else np.stack
            converted = a.copy(data=stack(parts, 0))
            converted.attrs["_variable_attrs"] = var_attrs
            out.append(converted)
        # JSON so the mapping survives the params (JSON header) round-trip
        import json as _json

        return out, _json.dumps(tgt_units, sort_keys=True)

    tgt = target if target not in (None, "") else das[0].units
    out = [convert_units_to(a, tgt) if isinstance(a, DataArray) else a for a in arrays]
    return out, units2str(tgt)


def infer_sampling_units(time) -> tuple[float, str]:
    """Return (multiplier, base unit) of the sampling frequency
    (reference units.py:50-92): daily data -> (1, 'd')."""
    freq = time.infer_freq() if hasattr(time, "infer_freq") else None
    if freq == "D":
        return 1, "d"
    if freq == "MS":
        return 1, "month"
    if freq == "YS":
        return 1, "a"
    m = re.match(r"^(\d+)D$", str(freq or ""))
    if m:
        return int(m.group(1)), "d"
    return 1, "d"


def str2pint(s) -> Quantity:
    """Alias of :func:`str2quantity` (reference units.py:120-201 name)."""
    return str2quantity(s)


#: Offset base -> CF unit for constant-length resampling frequencies
#: (reference units.py:38-46; consumed by :func:`infer_sampling_units`).
FREQ_UNITS = {"D": "d", "W": "week"}

#: Difference (delta) temperature units -> their absolute scale
#: (reference units.py:253-256: delta_degC -> K, delta_degF -> °R).
DELTA_ABSOLUTE_TEMP = {"delta_degC": "K", "delta_degF": "degR"}


def extract_units(arg) -> str | None:
    """The unit string of a DataArray / unit / quantity-string, or None for
    bare scalars (reference units.py:343-360)."""
    from .container import DataArray

    if isinstance(arg, DataArray):
        arg = arg.attrs.get("units", None)
    if isinstance(arg, (Unit, Quantity)):
        return units2str(arg.units if isinstance(arg, Quantity) else arg)
    if isinstance(arg, str):
        # "2" alone is dimensionless; a unit-ish string parses as units
        return units2str(parse_units(arg)) if not _QTY_RE.match(arg) else units2str(str2quantity(arg).units)
    if arg is None or np.isscalar(arg):
        return None
    raise TypeError(f"Argument must be str | DataArray | Unit | Quantity | scalar. Got {type(arg)}")


def pint2cfattrs(value, is_difference=None) -> dict:
    """CF-compliant unit attributes from a unit/quantity/string (reference
    ``units.py:260-293``): plain ``units``, plus ``units_metadata``
    disambiguating absolute vs difference temperature scales."""
    if isinstance(value, Quantity):
        value = value.units
    if isinstance(value, str):
        value = parse_units(value)
    s = str(value)
    if "delta_" in s:
        is_difference = True
        s = s.replace("delta_", "")
    attrs = {"units": s}
    if value.is_temperature:
        if is_difference:
            attrs["units_metadata"] = "temperature: difference"
        elif is_difference is False:
            attrs["units_metadata"] = "temperature: on_scale"
        else:
            attrs["units_metadata"] = "temperature: unknown"
    return attrs


def units2pint(obj) -> Unit:
    """Extract/parse the units of a DataArray or string (reference name)."""
    if hasattr(obj, "attrs"):
        return parse_units(obj.attrs.get("units", ""))
    return parse_units(obj)


def pint_multiply(da, q, out_units: str | None = None):
    """Multiply a DataArray by a quantity (string or Quantity), scaling data
    and composing units (reference units.py analogue used in tests)."""
    from .container import DataArray

    q = str2quantity(q) if isinstance(q, str) else q
    src = parse_units(da.units)
    new_dims = tuple(s + o for s, o in zip(src.dims, q.units.dims))
    new_scale = src.scale * q.units.scale
    out = DataArray(da.data * q.magnitude, da.dims, dict(da.coords), dict(da.attrs), da.name)
    if out_units is not None:
        tgt = parse_units(out_units)
        ok, extra = _commensurable(Unit(new_scale, new_dims), tgt)
        if not ok:
            raise ValueError(f"Cannot express result in {out_units!r}")
        out = DataArray(out.data * (new_scale / tgt.scale * extra), da.dims, dict(da.coords), dict(da.attrs), da.name)
        out.attrs["units"] = out_units
    else:
        out.attrs["units"] = f"{da.units} {q.units.raw}".strip()
    return out


def wavelength_to_normalized_wavenumber(lam, delta) -> float:
    """Convert a wavelength quantity to the normalized radial wavenumber
    ``alpha = 2*delta/lambda`` given the grid resolution ``delta``
    (reference units.py:424-489)."""
    d = str2quantity(delta).to("m").magnitude if isinstance(delta, str) else delta
    la = str2quantity(lam).to("m").magnitude if isinstance(lam, str) else lam
    return 2.0 * d / la


def normalized_wavenumber_to_wavelength(alpha, delta, units: str = "m"):
    """Inverse of :func:`wavelength_to_normalized_wavenumber`."""
    d = str2quantity(delta).to("m").magnitude if isinstance(delta, str) else delta
    lam_m = 2.0 * d / alpha
    return Quantity(lam_m, parse_units("m")).to(units).magnitude
