"""CF-calendar time coordinates, without cftime.

TPU-first rationale: the reference (Ouranosinc/xsdba) leans on xarray/pandas/cftime
datetime indexes at *runtime* (``base.py:274-345``).  On TPU everything about the
time axis is known at trace time, so we precompute plain int32/float32 component
arrays (year/month/day/dayofyear/...) on the host once and feed them to jitted
code as static metadata or device arrays.

Supported calendars mirror the reference's ``max_doy`` table (``base.py:105-115``):
standard / gregorian / proleptic_gregorian / julian / noleap / 365_day /
all_leap / 366_day / 360_day.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "CALENDAR_ALIASES",
    "MAX_DOY",
    "TimeIndex",
    "date_range",
    "days_in_month",
    "is_leap_year",
    "max_doy",
]

# Canonical names for each accepted alias.
CALENDAR_ALIASES = {
    "standard": "standard",
    "gregorian": "standard",
    "proleptic_gregorian": "standard",
    "default": "standard",
    "julian": "julian",
    "noleap": "noleap",
    "365_day": "noleap",
    "all_leap": "all_leap",
    "366_day": "all_leap",
    "360_day": "360_day",
}

# Maximum day-of-year per calendar — mirrors reference base.py:105-115.
MAX_DOY = {
    "standard": 366,
    "julian": 366,
    "noleap": 365,
    "all_leap": 366,
    "360_day": 360,
}

_DAYS_PER_MONTH = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
_DAYS_PER_MONTH_LEAP = np.array([31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
_CUM_DAYS = np.concatenate([[0], np.cumsum(_DAYS_PER_MONTH)])  # noleap cumulative
_CUM_DAYS_LEAP = np.concatenate([[0], np.cumsum(_DAYS_PER_MONTH_LEAP)])


def _canon(calendar: str) -> str:
    try:
        return CALENDAR_ALIASES[calendar]
    except KeyError as err:
        raise ValueError(f"Unknown calendar: {calendar!r}") from err


def max_doy(calendar: str) -> int:
    return MAX_DOY[_canon(calendar)]


def is_leap_year(year, calendar: str = "standard"):
    """Vectorized leap-year predicate per calendar."""
    cal = _canon(calendar)
    year = np.asarray(year)
    if cal == "standard":
        return (year % 4 == 0) & ((year % 100 != 0) | (year % 400 == 0))
    if cal == "julian":
        return year % 4 == 0
    if cal == "all_leap":
        return np.ones(year.shape, dtype=bool)
    return np.zeros(year.shape, dtype=bool)  # noleap, 360_day


def days_in_month(year, month, calendar: str = "standard"):
    """Vectorized number of days in each (year, month)."""
    cal = _canon(calendar)
    year = np.asarray(year)
    month = np.asarray(month)
    if cal == "360_day":
        return np.full(np.broadcast(year, month).shape, 30, dtype=np.int64)
    leap = is_leap_year(year, cal)
    return np.where(leap, _DAYS_PER_MONTH_LEAP[month - 1], _DAYS_PER_MONTH[month - 1])


def _days_in_year(year, calendar: str):
    cal = _canon(calendar)
    if cal == "360_day":
        return np.full(np.shape(year), 360, dtype=np.int64)
    return np.where(is_leap_year(year, cal), 366, 365).astype(np.int64)


# ---------------------------------------------------------------------------
# ordinal <-> (y, m, d) per calendar.  Ordinal 0 == year 1, Jan 1.
# ---------------------------------------------------------------------------


def _ymd_to_ordinal(year, month, day, calendar: str):
    cal = _canon(calendar)
    year = np.asarray(year, dtype=np.int64)
    month = np.asarray(month, dtype=np.int64)
    day = np.asarray(day, dtype=np.int64)
    if cal == "360_day":
        return (year - 1) * 360 + (month - 1) * 30 + (day - 1)
    if cal == "noleap":
        return (year - 1) * 365 + _CUM_DAYS[month - 1] + (day - 1)
    if cal == "all_leap":
        return (year - 1) * 366 + _CUM_DAYS_LEAP[month - 1] + (day - 1)
    y = year - 1
    if cal == "standard":
        ydays = 365 * y + y // 4 - y // 100 + y // 400
    else:  # julian
        ydays = 365 * y + y // 4
    leap = is_leap_year(year, cal)
    mdays = _CUM_DAYS[month - 1] + np.where((month > 2) & leap, 1, 0)
    return ydays + mdays + (day - 1)


def _ordinal_to_ymd(ordinal, calendar: str):
    cal = _canon(calendar)
    ordinal = np.asarray(ordinal, dtype=np.int64)
    if cal == "360_day":
        year = ordinal // 360 + 1
        rem = ordinal % 360
        month = rem // 30 + 1
        day = rem % 30 + 1
        return year, month, day
    if cal in ("noleap", "all_leap"):
        ylen = 365 if cal == "noleap" else 366
        cum = _CUM_DAYS if cal == "noleap" else _CUM_DAYS_LEAP
        year = ordinal // ylen + 1
        doy0 = ordinal % ylen
        month = np.searchsorted(cum, doy0, side="right").astype(np.int64)
        day = doy0 - cum[month - 1] + 1
        return year, month, day
    # standard / julian: estimate the year, then correct.
    approx_len = 365.2425 if cal == "standard" else 365.25
    year = (ordinal // approx_len).astype(np.int64) + 1
    # correct year so that ordinal of Jan 1 of `year` <= ordinal
    for _ in range(3):
        jan1 = _ymd_to_ordinal(year, 1, 1, cal)
        year = year - (jan1 > ordinal) + (ordinal - jan1 >= _days_in_year(year, cal))
    doy0 = ordinal - _ymd_to_ordinal(year, 1, 1, cal)
    leap = is_leap_year(year, cal)
    adj = np.where(leap & (doy0 >= 59), doy0 - 1, doy0)  # collapse Feb 29 for lookup
    month = np.searchsorted(_CUM_DAYS, adj, side="right").astype(np.int64)
    month = np.where(leap & (doy0 == 59), 2, month)  # Feb 29 itself
    first = _CUM_DAYS[month - 1] + np.where(leap & (month > 2), 1, 0)
    day = doy0 - first + 1
    return year, month, day


_DATE_RE = re.compile(r"^(\d{1,4})-(\d{1,2})-(\d{1,2})")


def _parse_date(date: str) -> tuple[int, int, int]:
    m = _DATE_RE.match(str(date))
    if not m:
        raise ValueError(f"Cannot parse date: {date!r}")
    return int(m.group(1)), int(m.group(2)), int(m.group(3))


@dataclass(frozen=True)
class TimeIndex:
    """A dense time coordinate: per-step calendar components, precomputed on host.

    This is the static metadata from which :class:`~xsdba_tpu.utils.grouper.Grouper`
    lowers groupings to integer index arrays (the TPU analogue of the reference's
    runtime ``da.time.dt`` accessors, ``base.py:274-345``).
    """

    year: np.ndarray
    month: np.ndarray
    day: np.ndarray
    calendar: str = "standard"
    freq: str | None = None
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "calendar", _canon(self.calendar))

    def __len__(self) -> int:
        return len(self.year)

    @property
    def size(self) -> int:
        return len(self.year)

    @property
    def dayofyear(self) -> np.ndarray:
        if "doy" not in self._cache:
            cal = self.calendar
            if cal == "360_day":
                doy = (self.month - 1) * 30 + self.day
            else:
                leap = is_leap_year(self.year, cal)
                if cal == "noleap":
                    leap = np.zeros_like(leap)
                elif cal == "all_leap":
                    leap = np.ones_like(leap)
                doy = _CUM_DAYS[self.month - 1] + np.where((self.month > 2) & leap, 1, 0) + self.day
            self._cache["doy"] = doy.astype(np.int64)
        return self._cache["doy"]

    @property
    def days_in_month(self) -> np.ndarray:
        return days_in_month(self.year, self.month, self.calendar)

    @property
    def days_in_year(self) -> np.ndarray:
        return _days_in_year(self.year, self.calendar)

    @property
    def is_leap_year(self) -> np.ndarray:
        return is_leap_year(self.year, self.calendar)

    @property
    def season(self) -> np.ndarray:
        """Season index 0..3 (0=DJF, 1=MAM, 2=JJA, 3=SON) — reference base.py:322."""
        return (self.month % 12) // 3

    @property
    def max_doy(self) -> int:
        return MAX_DOY[self.calendar]

    @property
    def ordinal(self) -> np.ndarray:
        if "ordinal" not in self._cache:
            self._cache["ordinal"] = _ymd_to_ordinal(self.year, self.month, self.day, self.calendar)
        return self._cache["ordinal"]

    @property
    def isoweek(self) -> np.ndarray:
        """Exact ISO-8601 week numbers (1..53) for real-world calendars.

        Matches ``pandas .isocalendar().week`` (reference ``base.py:324-325``)
        on standard/proleptic-gregorian dates: ISO weekday from the proleptic
        ordinal (0001-01-01 is a Monday), Thursday rule for year boundaries.
        Raises for idealized calendars (noleap/360_day/...), where ISO weeks
        are undefined — callers fall back to dayofyear blocks there.
        """
        if self.calendar != "standard":
            raise ValueError(f"ISO weeks are undefined for the {self.calendar!r} calendar.")
        wd = self.ordinal % 7 + 1  # 1=Monday .. 7=Sunday
        w = (self.dayofyear - wd + 10) // 7

        def weeks_in(y):
            def p(yy):
                return (yy + yy // 4 - yy // 100 + yy // 400) % 7

            return 52 + (((p(y) == 4) | (p(y - 1) == 3)).astype(np.int64))

        # both boundary rules test the RAW week number: early-January days can
        # belong to week 52/53 of the previous ISO year, late-December days to
        # week 1 of the next
        return np.where(
            w < 1, weeks_in(self.year - 1), np.where(w > weeks_in(self.year), 1, w)
        ).astype(np.int64)

    def infer_freq(self) -> str | None:
        """Best-effort frequency inference (D / MS / YS)."""
        if self.freq is not None:
            return self.freq
        if len(self) < 2:
            return None
        d = np.diff(self.ordinal)
        if np.all(d == 1):
            return "D"
        if np.all((self.day == 1)) and np.all(np.diff(self.year * 12 + self.month) == 1):
            return "MS"
        if np.all((self.day == 1) & (self.month == 1)) and np.all(np.diff(self.year) == 1):
            return "YS"
        return None

    def isel(self, idx) -> "TimeIndex":
        return TimeIndex(self.year[idx], self.month[idx], self.day[idx], self.calendar, None)

    def convert_calendar(self, calendar: str) -> "TimeIndex":
        """Naive date-preserving conversion (drops dates invalid in target)."""
        cal = _canon(calendar)
        dim = days_in_month(self.year, self.month, cal)
        keep = self.day <= dim
        return TimeIndex(self.year[keep], self.month[keep], self.day[keep], cal, None)

    def __eq__(self, other) -> bool:
        if not isinstance(other, TimeIndex):
            return NotImplemented
        return (
            self.calendar == other.calendar
            and len(self) == len(other)
            and bool(np.all(self.year == other.year))
            and bool(np.all(self.month == other.month))
            and bool(np.all(self.day == other.day))
        )

    def __hash__(self):
        return hash((self.calendar, len(self), self.year.tobytes(), self.month.tobytes(), self.day.tobytes()))


def date_range(start: str, periods: int, freq: str = "D", calendar: str = "standard") -> TimeIndex:
    """Generate a :class:`TimeIndex`, analogous to ``xr.date_range``.

    Supports ``D`` (and ``nD``), ``MS``, ``YS`` frequencies on any supported calendar.
    """
    cal = _canon(calendar)
    y0, m0, d0 = _parse_date(start)
    m = re.match(r"^(\d*)(D|MS|YS)$", freq)
    if not m:
        raise ValueError(f"Unsupported freq: {freq!r}")
    mult = int(m.group(1)) if m.group(1) else 1
    base = m.group(2)
    if base == "D":
        o0 = _ymd_to_ordinal(y0, m0, d0, cal)
        ords = o0 + np.arange(periods, dtype=np.int64) * mult
        yy, mm, dd = _ordinal_to_ymd(ords, cal)
        return TimeIndex(yy, mm, dd, cal, freq)
    if base == "MS":
        k = np.arange(periods, dtype=np.int64) * mult
        tot = (y0 * 12 + (m0 - 1)) + k
        yy = tot // 12
        mm = tot % 12 + 1
        dd = np.ones(periods, dtype=np.int64)
        return TimeIndex(yy, mm, dd, cal, freq)
    # YS: year starts (January 1)
    yy = y0 + np.arange(periods, dtype=np.int64) * mult
    mm = np.ones(periods, dtype=np.int64)
    dd = np.ones(periods, dtype=np.int64)
    return TimeIndex(yy, mm, dd, cal, freq)


# ---------------------------------------------------------------------------
# frequency-offset helpers — reference base.py:935-1066
# ---------------------------------------------------------------------------

_FREQ_RE = re.compile(r"^(\d*)([A-Za-z]+?)(?:-(\w+))?$")

_BASE_LENGTH_DAYS = {"D": 1, "W": 7, "M": 30.44, "Q": 91.3, "Y": 365.25, "A": 365.25, "H": 1 / 24, "T": 1 / 1440, "min": 1 / 1440, "S": 1 / 86400}


def parse_offset(freq: str) -> tuple[int, str, bool, str | None]:
    """Parse a frequency string into (multiplier, base, is_start_anchored,
    anchor) — reference base.py:935-990.  "nW" becomes "7n D"."""
    m = _FREQ_RE.match(str(freq))
    if not m:
        raise ValueError(f"Invalid frequency: {freq!r}")
    mult = int(m.group(1)) if m.group(1) else 1
    base = m.group(2)
    anchor = m.group(3)
    anchored = len(base) > 1 and base[0] in "AYQM"  # YS/ME/QS/... — NOT plain "S" (seconds)
    start = (anchored and base.endswith("S")) or base[0] not in "AYQM"
    if anchored and base.endswith(("S", "E")):
        base = base[:-1]
    if base == "W":
        # weekly lowers to 7-day periods; the weekday anchor is dropped, as in
        # the reference (base.py:969-973: xarray cftime has no "W")
        mult *= 7
        base = "D"
        anchor = None
    return mult, base, start, anchor


def construct_offset(mult: int, base: str, start_anchored: bool, anchor: str | None) -> str:
    """Inverse of :func:`parse_offset` — reference base.py:993-1028."""
    start = ("S" if start_anchored else "") if base in "YAQM" else ""
    if base == "W":
        mult = mult // 7
        base = "D"
    return f"{mult if mult > 1 else ''}{base}{start}{'-' + anchor if anchor else ''}"


def compare_offsets(freq_a: str, op: str, freq_b: str) -> bool:
    """Compare two frequency strings by approximate period length
    (reference base.py:1031-1043)."""
    import operator as _operator

    ops = {"<": _operator.lt, "<=": _operator.le, ">": _operator.gt, ">=": _operator.ge, "==": _operator.eq, "!=": _operator.ne}
    ma, ba, _, _ = parse_offset(freq_a)
    mb, bb, _, _ = parse_offset(freq_b)
    la = ma * _BASE_LENGTH_DAYS.get(ba, 1)
    lb = mb * _BASE_LENGTH_DAYS.get(bb, 1)
    return ops[op](la, lb)


def interpolate_doy_calendar(source, target_doy_max: int, target_doy_min: int = 1, axis: int = -1):
    """Linearly interpolate a dayofyear-indexed array onto another calendar's
    dayofyear range (reference base.py:895-931): 365 <-> 360 <-> 366."""
    source = np.asarray(source)
    n = source.shape[axis]
    src = np.moveaxis(source, axis, -1)
    old = np.linspace(target_doy_min, target_doy_max, n)
    new = np.arange(target_doy_min, target_doy_max + 1)
    out = np.apply_along_axis(lambda row: np.interp(new, old, row), -1, src)
    return np.moveaxis(out, -1, axis)
