"""Daily calendars, worked out from their month lengths and leap rule alone.

A series is a run of whole years from January 1 of its start year.  Every
year of ``noleap`` (``365_day``) has the same 365 days; ``standard``
(``gregorian``, ``proleptic_gregorian``) adds February 29 in the
Gregorian leap years, so its day of year runs to 366.  Each day's year,
month, day of month and day of year follow from the month lengths below.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MONTH_DAYS = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
YEAR_DAYS = 365
NOLEAP = ("noleap", "365_day")
STANDARD = ("standard", "gregorian", "proleptic_gregorian")


@dataclass(frozen=True)
class Days:
    """A daily series of ``years`` whole years from January 1 of
    ``start_year``: per day its year, month (1..12), day of month (1..31),
    day of year (1..366) and its month's length; ``max_doy``, the
    calendar's longest year (the day-of-year groups, whether the series
    holds that day or not)."""

    start_year: int
    years: int
    max_doy: int
    year: np.ndarray
    month: np.ndarray
    day: np.ndarray
    doy: np.ndarray
    month_len: np.ndarray

    @property
    def n(self) -> int:
        return len(self.year)


def parse_start(start: str) -> int:
    """The year of a ``YYYY-01-01`` start date (a series of whole years
    starts on January 1)."""
    y, m, d = (int(p) for p in start.split("-"))
    if (m, d) != (1, 1):
        raise ValueError(f"a series of whole years starts on January 1, got {start!r}")
    return y


def is_leap(year: np.ndarray) -> np.ndarray:
    return (year % 4 == 0) & ((year % 100 != 0) | (year % 400 == 0))


def days(calendar: str, start: str, years: int) -> Days:
    """The days of ``years`` whole years of ``calendar`` from ``start``."""
    if calendar not in NOLEAP + STANDARD:
        raise NotImplementedError(f"no calendar {calendar!r}")
    y0 = parse_start(start)
    year, month, day, doy, month_len = [], [], [], [], []
    for y in range(y0, y0 + years):
        lens = MONTH_DAYS.copy()
        if calendar in STANDARD and is_leap(np.int64(y)):
            lens[1] = 29
        m = np.repeat(np.arange(1, 13), lens)
        first = np.concatenate([[0], np.cumsum(lens)[:-1]])
        d = np.arange(len(m))
        year.append(np.full(len(m), y))
        month.append(m)
        day.append(d - first[m - 1] + 1)
        doy.append(d + 1)
        month_len.append(lens[m - 1])
    cat = np.concatenate
    max_doy = 366 if calendar in STANDARD else YEAR_DAYS
    return Days(y0, years, max_doy, cat(year), cat(month), cat(day), cat(doy), cat(month_len))


def month_members(days: Days) -> list[np.ndarray]:
    """For each month 1..12, the positions of its days in the series."""
    return [np.flatnonzero(days.month == m) for m in range(1, 13)]


def doy_members(days: Days) -> list[np.ndarray]:
    """For each day of year 1..the calendar's ``max_doy``, the positions of
    its days (none for day 366 in a series without a leap year)."""
    return [np.flatnonzero(days.doy == d) for d in range(1, days.max_doy + 1)]


def window_members(days: Days, window: int) -> np.ndarray:
    """[groups, window * most centres] positions of the members of each
    day-of-year group under a centred rolling window of ``window`` days:
    for every day ``t`` of that day of year, the days ``t - window // 2 ..
    t + window // 2`` of the series; a position before the first day or
    after the last, or past a group's own centres, is -1 (no member)."""
    centres = doy_members(days)
    offs = np.arange(window) - window // 2
    rows = np.full((len(centres), window * max(len(c) for c in centres)), -1, dtype=np.int64)
    for g, c in enumerate(centres):
        pos = (c[:, None] + offs[None, :]).ravel()
        rows[g, : len(pos)] = np.where((pos < 0) | (pos >= days.n), -1, pos)
    return rows
