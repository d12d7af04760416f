"""Time grouping, lowered to static integer index arrays.

The reference's ``Grouper`` (``base.py:118-501``) performs runtime
``groupby``/``rolling`` over xarray objects.  All calendar structure is known
before any compute runs, so a grouping lowers to *static* host-computed arrays:

- ``group_idx[T]``   int32 group id of each timestep (0-based),
- ``frac_idx[T]``    float interpolation index (reference ``base.py:274-345``:
  month → ``month - 0.5 + day/days_in_month``; season → ``doy/year_len*4 - 1/6``;
  dayofyear → ``doy``),
- ``gather_idx[G, L]`` int32, padded with ``-1``: for each group, the timesteps
  that fall inside its (optionally windowed) membership.  This reproduces the
  reference's ``rolling(...).construct("window")`` + ``groupby`` semantics
  (``base.py:261-265``) exactly — including out-of-series window positions, which
  pad with ``-1`` and are treated as NaN by nan-aware kernels — as one fused
  gather instead of a runtime groupby.

The equivalent generalizes the reference's own ``grouped_time_indexes``
(``processing.py:829-918``), which it also implements (the "5D" MBCn grouping).
"""

from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass

import numpy as np

from .calendar import TimeIndex
from .profiling import span

__all__ = ["Grouper", "GroupIndexes", "parse_group", "partition_by_group"]

_PROPS = ("group", "month", "season", "dayofyear", "week")

# Output coordinate labels per prop (reference base.py:207-230).
_SEASONS = ("DJF", "MAM", "JJA", "SON")


@dataclass(frozen=True, eq=False)  # identity eq/hash: usable as a weak cache key
class WindowMergePlan:
    """Host-side plan for the shared-sort windowed grouped quantile.

    For windowed groupings where group ``g``'s gather row is exactly the
    union of the window-1 member lists of groups ``[g-half, g-half+window)``
    (true for all interior dayofyear groups and all "5D" groups), the grouped
    quantile can be computed by sorting each window-1 list ONCE and merging
    ``window`` pre-sorted lists per group (``ops/pallas/merge_kernel.py``) —
    removing the reference rolling-construct's `window`-fold sort
    amplification (``base.py:261-265``).  Groups failing the union check
    (year-boundary wraps, series edges) are listed in ``edge_ids`` and go
    through the exact gather+sort path.
    """

    w1_gather: np.ndarray   # [G + 2*half, Ymax] int32, -1 padded extended lists
    fast_mask: np.ndarray   # [G] bool: row == union of w1 lists in window
    edge_ids: np.ndarray    # [Ge] int32 groups needing the exact path
    edge_gather: np.ndarray  # [Ge, L] int32 rows of the exact gather matrix
    half: int               # left extent of the window (window//2)
    window: int
    ypad: int               # next pow2 >= Ymax (merge list length)
    wpad: int               # next pow2 >= window
    dblock: int             # kernel block rows (max(wpad, 32))
    dp: int                 # padded row count of the kernel input
    nv_host: np.ndarray | None = None  # [G] windowed member counts (valid
                                       # counts when the data is NaN-free —
                                       # enables fully-static extraction)
    regular_period: int | None = None  # P when w1 core rows are the transpose
                                       # of the [years, P] time reshape (and
                                       # the virtual wrap rows are year-shifted
                                       # slices of it): slab build by
                                       # reshape+swapaxes instead of gathers
    sel_labels: np.ndarray | None = None  # [T] int32 packed start*1024+length
                                          # cyclic group-interval membership
                                          # (counting-selection backend; None
                                          # when membership is not a cyclic
                                          # interval per element — see
                                          # ops.selquant.interval_membership)

    @property
    def n_fast(self) -> int:
        return int(self.fast_mask.sum())


def _next_pow2(n: int) -> int:
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


def _window_merge_plan(gidx, gather_idx, n_groups: int, window: int, prop: str):
    """Build a :class:`WindowMergePlan` (or None when inapplicable).

    ``w1_gather`` holds ``G + 2*half`` rows: row ``i`` is the member list of
    *virtual* group ``i - half``.  The out-of-range virtual rows are the
    year-shifted wrap lists (previous year's trailing doys minus its last
    year; next year's leading doys minus its first year), which is exactly
    what the rolling window crosses at year boundaries — so on regular
    calendars every group satisfies the union property and no group needs
    the exact re-sort path.  Groups whose gather row still differs (partial
    first/last years, leap calendars) are verified per group and fall back
    via ``edge_ids``.
    """
    if window <= 1 or prop not in ("dayofyear", "5D"):
        return None
    G = n_groups
    half = window // 2 if prop == "dayofyear" else (window - 1) // 2
    # window-1 member lists from group_idx
    order = np.argsort(gidx, kind="stable")
    counts = np.bincount(gidx, minlength=G)
    Ymax = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    w1 = np.full((G, Ymax), -1, dtype=np.int32)
    for g in range(G):
        m = order[starts[g] : starts[g + 1]]
        w1[g, : len(m)] = m
    # extended rows: virtual groups -half..-1 and G..G+half-1
    Gx = G + 2 * half
    w1x = np.full((Gx, Ymax), -1, dtype=np.int32)
    w1x[half : half + G] = w1
    if prop == "dayofyear":
        for i in range(half):
            # virtual doy (i - half) < 0: previous year's doy G+i-half,
            # shifted back one year => drop its last (latest-year) member
            m = order[starts[G - half + i] : starts[G - half + i + 1]]
            if len(m) > 1:
                w1x[i, : len(m) - 1] = m[:-1]
            # virtual doy G+i: next year's doy i, shifted forward one year
            # => drop its first (earliest-year) member
            m = order[starts[i] : starts[i + 1]]
            if len(m) > 1:
                w1x[G + half + i, : len(m) - 1] = m[1:]
    # exactness check: row g's valid set == union of extended lists in window
    fast = np.zeros(G, dtype=bool)
    for g in range(G):
        win = w1x[g : g + window]
        union = win[win >= 0]
        row = gather_idx[g]
        row = np.sort(row[row >= 0])
        fast[g] = len(row) == len(union) and bool(np.array_equal(row, np.sort(union)))
    if not fast.any():
        return None
    edge_ids = np.flatnonzero(~fast).astype(np.int32)
    wpad = _next_pow2(window)
    dblock = max(wpad, 32)
    dp = ((G - 1) // dblock + 2) * dblock
    if dp < Gx + wpad + 8:  # superset loads must stay in range
        dp = ((Gx + wpad + 8 - 1) // dblock + 1) * dblock
    lens = (w1x >= 0).sum(axis=1).astype(np.int64)
    nv_host = np.array([int(lens[g : g + window].sum()) for g in range(G)], dtype=np.int64)

    # regular layout: T == G*Ymax with w1[half+g, y] == y*G + g, and the
    # virtual wrap rows equal to the year-dropped slices the fast slab build
    # would construct — then the whole gather is a reshape+swapaxes
    regular = None
    T = len(gidx)
    if prop == "dayofyear" and T == G * Ymax and half > 0:
        y_i, g_i = np.meshgrid(np.arange(Ymax, dtype=np.int64), np.arange(G, dtype=np.int64))
        core_ok = np.array_equal(w1x[half : half + G], (y_i * G + g_i).astype(np.int32))
        if core_ok:
            head = np.full((half, Ymax), -1, dtype=np.int32)
            tail = np.full((half, Ymax), -1, dtype=np.int32)
            for i in range(half):
                head[i, : Ymax - 1] = np.arange(Ymax - 1, dtype=np.int64) * G + (G - half + i)
                tail[i, : Ymax - 1] = (np.arange(Ymax - 1, dtype=np.int64) + 1) * G + i
            if np.array_equal(w1x[:half], head) and np.array_equal(w1x[half + G :], tail):
                regular = G

    from ..ops.selquant import interval_membership, pack_labels

    iv = interval_membership(gather_idx, G, T)
    sel_labels = pack_labels(*iv) if iv is not None else None

    return WindowMergePlan(
        w1_gather=w1x,
        fast_mask=fast,
        edge_ids=edge_ids,
        edge_gather=gather_idx[edge_ids].astype(np.int32) if len(edge_ids) else np.empty((0, gather_idx.shape[1]), np.int32),
        half=half,
        window=window,
        ypad=_next_pow2(Ymax),
        wpad=wpad,
        dblock=dblock,
        dp=dp,
        nv_host=nv_host,
        regular_period=regular,
        sel_labels=sel_labels,
    )


@dataclass(frozen=True)
class GroupIndexes:
    """Static lowering of a (Grouper, TimeIndex) pair."""

    n_groups: int
    group_idx: np.ndarray        # [T] int32, 0-based group of each timestep
    frac_idx: np.ndarray         # [T] float64 fractional interp index
    gather_idx: np.ndarray       # [G, L] int32, -1 padded
    group_counts: np.ndarray     # [G] int32, valid entries per row of gather_idx
    scatter_slot: np.ndarray     # [T] int32: column of gather_idx[group_idx[t]] holding t
                                 # (the window-center slot when window > 1 — the
                                 # analogue of reference `isel(window=window//2)`,
                                 # base.py:425-430)
    coord: np.ndarray            # [G] output coordinate (1-based months/doys, season strings)
    prop: str
    window: int
    merge_plan: WindowMergePlan | None = None

    @property
    def max_members(self) -> int:
        return self.gather_idx.shape[1]

    @property
    def positions(self) -> np.ndarray:
        """Numeric group positions on the frac_idx axis (seasons -> 0..3,
        months -> 1..12, dayofyear -> 1..maxdoy)."""
        if self.prop in ("season", "5D", "week"):
            return np.arange(self.n_groups, dtype=np.float64)
        if self.prop == "group":
            return np.array([1.0])
        return np.asarray(self.coord, dtype=np.float64)

    def expand(self, n_add: int) -> "GroupIndexes":
        """Expanded indexes over a flattened ``[A*T]`` axis.

        For Grouper ``add_dims`` pooling (reference ``base.py:413``: the
        grouped reduction runs over ``[dim] + add_dims + window``): the extra
        dims are folded into the time axis as ``A`` stacked copies of the
        series, and each group's gather row pools the members of every copy.
        The rolling window stays within a copy (the reference constructs the
        window along ``dim`` before reducing over ``add_dims``).
        """
        if n_add == 1:
            return self
        # memoized per instance: the expanded plan is an identity key for
        # device-side caches (plan arrays, finite hints), so repeated API
        # calls must see the SAME object
        memo = self.__dict__.get("_expand_memo")
        if memo is None:
            memo = {}
            object.__setattr__(self, "_expand_memo", memo)
        if n_add in memo:
            return memo[n_add]
        T = len(self.group_idx)
        G, L = self.gather_idx.shape
        offs = (np.arange(n_add, dtype=np.int64) * T)[:, None, None]
        g = np.where(self.gather_idx[None] < 0, -1, self.gather_idx[None].astype(np.int64) + offs)
        gather = np.moveaxis(g, 0, 1).reshape(G, n_add * L)
        slot = (np.arange(n_add, dtype=np.int64)[:, None] * L + self.scatter_slot[None, :]).reshape(-1)
        # The merge plan survives pooling: copy ``a`` of virtual group ``i``'s
        # window-1 member list is the original list offset by ``a*T``, so the
        # pooled extended row is the concatenation of the offset copies (order
        # within a row is irrelevant — rows are sorted before merging), and
        # the union property per group is preserved verbatim (both the pooled
        # gather row and the pooled window union are the offset-union of the
        # originals).  Only the regular-reshape fast path is lost: its wrap
        # rows drop one year per *copy*, which a single flat reshape of the
        # ``[A*T]`` axis cannot express.
        plan = self.merge_plan
        if plan is not None:
            Gx, Ymax = plan.w1_gather.shape
            w1 = np.where(
                plan.w1_gather[None] < 0,
                np.int64(-1),
                plan.w1_gather[None].astype(np.int64) + offs,
            )
            w1 = np.moveaxis(w1, 0, 1).reshape(Gx, n_add * Ymax).astype(np.int32)
            plan = WindowMergePlan(
                w1_gather=w1,
                fast_mask=plan.fast_mask,
                edge_ids=plan.edge_ids,
                edge_gather=gather[plan.edge_ids].astype(np.int32)
                if len(plan.edge_ids)
                else np.empty((0, gather.shape[1]), np.int32),
                half=plan.half,
                window=plan.window,
                ypad=_next_pow2(n_add * Ymax),
                wpad=plan.wpad,
                dblock=plan.dblock,
                dp=plan.dp,
                nv_host=None
                if plan.nv_host is None
                else (plan.nv_host * n_add).astype(np.int64),
                regular_period=None,
                # intervals are per-element and copies keep their element's
                # groups, so the pooled labels are the tiled originals
                sel_labels=None
                if plan.sel_labels is None
                else np.tile(plan.sel_labels, n_add),
            )
        out = GroupIndexes(
            n_groups=self.n_groups,
            group_idx=np.tile(self.group_idx, n_add),
            frac_idx=np.tile(self.frac_idx, n_add),
            gather_idx=gather.astype(np.int32),
            group_counts=(self.group_counts.astype(np.int64) * n_add).astype(np.int32),
            scatter_slot=slot.astype(np.int32),
            coord=self.coord,
            prop=self.prop,
            window=self.window,
            merge_plan=plan,
        )
        memo[n_add] = out
        return out

    def bracket_partitions(self, method: str = "linear"):
        """Static partitions of the time axis by *bracketing padded group*.

        For grouped adjust-time interpolation: each timestep's fractional
        index falls between two cyclically-padded groups g0 <= frac < g1 with
        blend weight w (reference add_cyclic_bounds + .interp semantics,
        utils.py:222-232).  The bracketing is a pure function of the calendar,
        so it is computed here once on host, and returned as two -1-padded
        gather matrices over the padded-group axis plus per-timestep
        (row, col) scatter coordinates — turning the device-side lookup into
        two vectorized per-partition table evaluations with only cheap
        long-axis gathers (see ops/interp.interp_grouped_partitioned).

        Returns dict with g0/g1 [T], w [T], part0/part1 [Gp, Lp],
        slot0/slot1 [T], n_padded.
        """
        pos = self.positions
        G = self.n_groups
        frac = self.frac_idx
        if G > 1:
            pos_p = np.concatenate([[pos[0] - (pos[1] - pos[0])], pos, [pos[-1] + (pos[-1] - pos[-2])]])
        else:
            pos_p = pos
        Gp = len(pos_p)
        if method == "nearest" or G == 1:
            g = np.clip(np.searchsorted(pos_p, frac, side="left"), 1, Gp - 1)
            g0 = np.where(frac - pos_p[g - 1] < pos_p[g] - frac, g - 1, g)
            g1 = g0
            w = np.zeros_like(frac)
        else:
            g1 = np.clip(np.searchsorted(pos_p, frac, side="right"), 1, Gp - 1)
            g0 = g1 - 1
            p0v, p1v = pos_p[g0], pos_p[g1]
            w = np.where(p1v > p0v, (frac - p0v) / np.where(p1v == p0v, 1, p1v - p0v), 0.0)

        part0, slot0 = partition_by_group(g0, Gp)
        part1, slot1 = partition_by_group(g1, Gp)

        def regular_period(part):
            # rows 1..P full with part[1+i, y] == y*P + i and empty pad rows:
            # the partition gather is then a [years, P] reshape + transpose
            P, (Gp_, Lp) = part.shape[0] - 2, part.shape
            if P < 1 or P * Lp != len(frac):
                return None
            if (part[0] != -1).any() or (part[-1] != -1).any():
                return None
            expect = (np.arange(Lp, dtype=np.int64)[None, :] * P + np.arange(P, dtype=np.int64)[:, None])
            return P if np.array_equal(part[1:-1], expect.astype(part.dtype)) else None

        return {
            "g0": g0.astype(np.int32),
            "g1": g1.astype(np.int32),
            "w": w.astype(np.float64),
            "part0": part0,
            "slot0": slot0,
            "part1": part1,
            "slot1": slot1,
            "n_padded": Gp,
            "regular0": regular_period(part0),
        }


def partition_by_group(gsel, n_groups: int):
    """Static partition of the time axis by group id ``gsel`` [T]: (part
    [n_groups, L] of time indices in order, -1 padded; slot [T], each
    step's column in its group's row), both int32."""
    T = len(gsel)
    counts = np.bincount(gsel, minlength=n_groups)
    L = max(int(counts.max(initial=0)), 1)
    order = np.argsort(gsel, kind="stable")
    sorted_g = gsel[order]
    start = np.searchsorted(sorted_g, np.arange(n_groups), side="left")
    within = np.arange(T) - start[sorted_g]
    part = np.full((n_groups, L), -1, dtype=np.int32)
    part[sorted_g, within] = order
    slot = np.zeros(T, dtype=np.int32)
    slot[order] = within
    return part, slot


class Grouper:
    """Parse a group string ("time", "time.month", "time.season",
    "time.dayofyear", "time.week", "5D") + window into static indexes.

    API mirrors the reference ``Grouper`` (``base.py:118-230``); the runtime
    ``apply`` machinery is replaced by :meth:`indexes` + tensor segment ops.
    """

    PROP = "<PROP>"
    DIM = "<DIM>"
    ADD_DIMS = "<ADD_DIMS>"

    def __init__(self, group: str, window: int = 1, add_dims=None):
        if group == "time" and window > 1:
            raise ValueError(
                "The group given is 'time' but window > 1; windows do not apply "
                "to whole-series grouping."
            )
        if "." in group:
            dim, prop = group.split(".")
        else:
            dim, prop = group, "group"
        if group == "5D":  # MBCn-only special grouping (reference base.py:161-164)
            dim, prop = "time", "5D"
        if prop not in _PROPS + ("5D",):
            raise ValueError(f"Unsupported group: {group!r}")
        if isinstance(add_dims, str):
            add_dims = [add_dims]
        self.dim = dim
        self.prop = prop
        self.name = group
        self.window = int(window)
        self.add_dims = list(add_dims or [])

    def __repr__(self):
        return f"Grouper(group={self.name!r}, window={self.window})"

    def __eq__(self, other):
        if isinstance(other, str):
            return self.name == other and self.window == 1
        if isinstance(other, Grouper):
            return self.name == other.name and self.window == other.window
        return NotImplemented

    def __hash__(self):
        return hash((self.name, self.window))

    @property
    def prop_name(self) -> str:
        return "year" if self.prop == "group" else self.prop

    # -- static lowering --------------------------------------------------

    def get_coordinate(self, time: TimeIndex | None = None) -> np.ndarray:
        """Output coordinate of grouped reductions (reference base.py:207-230)."""
        if self.prop == "month":
            return np.arange(1, 13)
        if self.prop == "season":
            return np.array(_SEASONS)
        if self.prop == "dayofyear":
            mdoy = time.max_doy if time is not None else 365
            return np.arange(1, mdoy + 1)
        if self.prop == "group":
            return np.array([1])
        if self.prop == "week":
            return np.arange(1, 54)
        if self.prop == "5D":
            # 73 five-day blocks of the year (reference processing.py:884-906)
            return np.arange(73)
        raise NotImplementedError(f"No coordinate for {self.prop}")

    def group_of(self, time: TimeIndex) -> np.ndarray:
        """0-based integer group id per timestep."""
        if self.prop == "group":
            return np.zeros(len(time), dtype=np.int32)
        if self.prop == "month":
            return (time.month - 1).astype(np.int32)
        if self.prop == "season":
            return time.season.astype(np.int32)
        if self.prop == "dayofyear":
            return (time.dayofyear - 1).astype(np.int32)
        if self.prop == "week":
            # Exact ISO weeks (pandas isocalendar parity, reference
            # base.py:324-325) on the standard calendar; idealized calendars
            # (noleap/360_day/...) have no ISO weeks — fall back to
            # dayofyear//7 blocks there (documented in docs/PARITY.md).
            try:
                return (time.isoweek - 1).astype(np.int32)
            except ValueError:
                return np.minimum((time.dayofyear - 1) // 7, 52).astype(np.int32)
        if self.prop == "5D":
            # 5-day blocks of the year (reference processing.py:888-906):
            # block b covers dayofyear in [5b+1, 5b+5].
            return np.minimum((time.dayofyear - 1) // 5, 72).astype(np.int32)
        raise NotImplementedError(self.prop)

    def interp_index(self, time: TimeIndex) -> np.ndarray:
        """Fractional group index for interpolation (reference base.py:293-310)."""
        if self.prop == "month":
            return time.month - 0.5 + time.day / time.days_in_month
        if self.prop == "season":
            return time.dayofyear / time.days_in_year * 4 - 1 / 6
        if self.prop == "dayofyear":
            return time.dayofyear.astype(np.float64)
        if self.prop == "group":
            return np.ones(len(time), dtype=np.float64)
        raise ValueError(f"Interpolation is not supported for time.{self.prop}.")

    def get_index(self, da, interp: bool | None = None):
        """Group index of each timestep as a DataArray (reference
        ``base.py:274-345``): the 1-based group label per element, or the
        fractional interpolation index when ``interp`` (month/season)."""
        from .container import DataArray

        time = da.time if hasattr(da, "time") else da
        if self.prop == "group":
            vals = np.ones(len(time), dtype=np.int64)
        elif interp:
            vals = self.interp_index(time)
        else:
            gidx = self.group_of(time)
            coord = self.get_coordinate(time)
            vals = coord[gidx] if coord.dtype.kind in "iuf" else gidx
        name = self.prop_name if self.prop != "group" else "group"
        return DataArray(vals, ("time",), {"time": time}, {}, name)

    def n_groups(self, time: TimeIndex | None = None) -> int:
        return len(self.get_coordinate(time))

    def indexes(self, time: TimeIndex) -> GroupIndexes:
        """Lower to static index arrays (cached per TimeIndex; a build is
        the span ``lower.indexes``)."""
        key = ("groupidx", self.name, self.window)
        cache = time._cache
        if key not in cache:
            with span("lower.indexes"):
                cache[key] = self._lower(time)
        return cache[key]

    def _lower(self, time: TimeIndex) -> GroupIndexes:
        T = len(time)
        gidx = self.group_of(time)
        G = self.n_groups(time)
        try:
            frac = self.interp_index(time)
        except ValueError:
            frac = gidx.astype(np.float64)

        half = self.window // 2
        # Membership with rolling window: center t in group g contributes
        # positions t-half..t+half; out-of-range positions stay -1 (NaN pad),
        # matching rolling(center=True).construct + groupby (base.py:261-265).
        members: list[np.ndarray] = [np.flatnonzero(gidx == g) for g in range(G)]
        counts = np.array([len(m) for m in members], dtype=np.int64)
        L = int(counts.max()) if T else 0
        slot = np.zeros(T, dtype=np.int64)
        if self.prop == "5D" and self.window > 1:
            # MBCn "5D" grouping: the window counts 5-day *blocks*, not
            # timesteps (reference processing.py:884-910) — group b's windowed
            # members are the member days of blocks b-h..b+h, no wraparound.
            if self.window % 2 == 0:
                raise ValueError(f"Group 5D only works with an odd window, got window={self.window}")
            h = (self.window - 1) // 2
            Lb = L
            rows = np.full((G, Lb * self.window), -1, dtype=np.int64)
            for b in range(G):
                for k, o in enumerate(range(-h, h + 1)):
                    bo = b + o
                    if 0 <= bo < G:
                        m = members[bo]
                        rows[b, k * Lb : k * Lb + len(m)] = m
                slot[members[b]] = h * Lb + np.arange(len(members[b]))
        elif self.window > 1:
            L *= self.window
            rows = np.full((G, L), -1, dtype=np.int64)
            # exactly `window` offsets; even windows take the extra point on
            # the left, matching xarray's center=True rolling
            offs = np.arange(self.window) - half
            for g, cen in enumerate(members):
                if len(cen) == 0:
                    continue
                w = (cen[:, None] + offs[None, :]).ravel()
                w[(w < 0) | (w >= T)] = -1
                rows[g, : len(w)] = w
                slot[cen] = np.arange(len(cen)) * self.window + half
        else:
            rows = np.full((G, max(L, 1)), -1, dtype=np.int64)
            for g, m in enumerate(members):
                rows[g, : len(m)] = m
                slot[m] = np.arange(len(m))
        valid = (rows >= 0).sum(axis=1).astype(np.int32)
        plan = _window_merge_plan(gidx, rows.astype(np.int32), G, self.window, self.prop)

        return GroupIndexes(
            n_groups=G,
            group_idx=gidx.astype(np.int32),
            frac_idx=np.asarray(frac, dtype=np.float64),
            gather_idx=rows.astype(np.int32),
            group_counts=valid,
            scatter_slot=slot.astype(np.int32),
            coord=self.get_coordinate(time),
            prop=self.prop,
            window=self.window,
            merge_plan=plan,
        )


def period_blocks(time: TimeIndex, prop: str):
    """Static indexes of *resample periods* within groups.

    For diagnostics that first reduce each calendar period (one specific
    January, one specific season instance, one year) then aggregate periods
    within a group (the reference's ``resample(freq).map`` + groupby pattern,
    e.g. properties.py:354-380): returns (gather [P, L] int32 -1-padded,
    period_group [P] int32) where P runs over individual periods.  Cached
    on the TimeIndex, as :meth:`Grouper.indexes` is; callers must not
    modify the arrays.
    """
    key = ("period_blocks", prop)
    if key not in time._cache:
        time._cache[key] = _period_blocks(time, prop)
    return time._cache[key]


def _period_blocks(time: TimeIndex, prop: str):
    T = len(time)
    if prop == "month":
        keys = time.year * 12 + (time.month - 1)
        groups = (time.month - 1).astype(np.int64)
    elif prop == "season":
        # DJF belongs to the year of its January (Dec rolls forward)
        yr = time.year + (time.month == 12)
        keys = yr * 4 + time.season
        groups = time.season.astype(np.int64)
    elif prop in ("group", "time"):
        keys = time.year
        groups = np.zeros(T, dtype=np.int64)
    else:
        raise NotImplementedError(f"period_blocks for {prop!r}")
    uniq, inv = np.unique(keys, return_inverse=True)
    P = len(uniq)
    counts = np.bincount(inv, minlength=P)
    gather = np.full((P, int(counts.max())), -1, dtype=np.int32)
    order = np.argsort(inv, kind="stable")                      # each period's days, in time order
    gather[inv[order], np.arange(T) - np.repeat(np.cumsum(counts) - counts, counts)] = order
    period_group = np.zeros(P, dtype=np.int32)
    period_group[inv] = groups                                  # a period lies in one group
    return gather, period_group


def parse_group(func=None, *, kwargs=None):
    """Decorator converting a ``group=str`` kwarg into a :class:`Grouper`.

    Mirrors reference ``base.py:504-538``: pulls ``window`` into the Grouper.
    """

    def _decorator(f):
        sig = inspect.signature(f)
        has_window = "window" in sig.parameters

        @functools.wraps(f)
        def _wrapped(*args, **kw):
            group = kw.get("group")
            if isinstance(group, str):
                window = kw.pop("window", 1) if not has_window else kw.get("window", 1)
                kw["group"] = Grouper(group, window=window)
            return f(*args, **kw)

        return _wrapped

    if func is not None:
        return _decorator(func)
    return _decorator


#: element budget for one gathered [..., chunk, L] slice in Grouper.apply
#: (~1 GB at f64); windowed-doy gathers on large site batches would otherwise
#: materialize [..., 366, years*window] in one shot.
_APPLY_CHUNK_BUDGET = 1 << 27


def _apply_func_chunked(x, gi, func, group_chunk: int | None, allow_transform: bool = True):
    """Evaluate ``func`` over the gathered group matrix of ``x`` [..., T] in
    group chunks, bounding peak memory to one [..., chunk, L] slice.

    Returns ``("reduce", out [..., G, ...])`` or — when ``func`` keeps the
    [..., C, L] shape — ``("transform", ts [..., T])`` with each timestep's
    window-center value scattered back.
    """
    import torch

    from ..ops.segment import gather_groups, scatter_back

    G, L = gi.gather_idx.shape
    batch = int(np.prod(x.shape[:-1], dtype=np.int64)) if x.ndim > 1 else 1
    if group_chunk is None:
        group_chunk = max(1, min(G, _APPLY_CHUNK_BUDGET // max(batch * L, 1)))
    gidx = torch.as_tensor(gi.gather_idx, device=x.device)

    def gathered(sl):
        return gather_groups(x, gidx[sl])

    C0 = min(group_chunk, G)
    first = func(gathered(slice(0, C0)))
    is_transform = allow_transform and first.ndim == x.ndim + 1 and tuple(first.shape[-2:]) == (C0, L)
    g_of_t = torch.as_tensor(gi.group_idx, device=x.device).long()
    slot = torch.as_tensor(gi.scatter_slot, device=x.device).long()
    if group_chunk >= G:
        if is_transform:
            return "transform", scatter_back(first, g_of_t, slot)
        return "reduce", first

    if is_transform:
        ts = torch.full(x.shape, torch.nan, dtype=first.dtype, device=x.device)
        for k in range(0, G, group_chunk):
            C = min(group_chunk, G - k)
            out_k = first if k == 0 else func(gathered(slice(k, k + C)))
            sel = (g_of_t >= k) & (g_of_t < k + C)
            local = torch.clamp(g_of_t - k, 0, C - 1)
            ts = torch.where(sel, out_k[..., local, slot], ts)
        return "transform", ts
    outs = [first]
    for k in range(group_chunk, G, group_chunk):
        outs.append(func(gathered(slice(k, min(k + group_chunk, G)))))
    # the group axis sits where the time axis was (func reduced L away)
    return "reduce", torch.cat(outs, dim=x.ndim - 1)


def _grouper_apply(self, func, da, main_only: bool = False, group_chunk: int | None = None):
    """Apply a reduction group-wise (reference ``Grouper.apply``,
    base.py:347-457, reduced to its tensor essence).

    ``func`` is "mean"/"std"/"sum"/"min"/"max" or a callable taking the
    gathered [..., G, L] tensor.  A callable that reduces the last axis
    yields a grouped DataArray ([..., G]); window pads are NaN (skipped by
    the named reductions).  A callable that *keeps* the [..., G, L] shape is
    a transform: its result is scattered back onto the time axis (window
    center slot), matching the reference's non-reducing apply + sortby(dim)
    + isel(window=window//2) behavior (base.py:438-450).  Unless
    ``main_only``, ``add_dims`` are folded into the gathered axis and
    reduced too (reference base.py:413).

    Named reductions are processed ``group_chunk`` groups at a time
    (auto-sized to a fixed element budget).  Callables see the full gather
    by default; pass ``group_chunk`` explicitly to chunk one — that asserts
    the callable treats groups independently.
    """
    from .container import DataArray
    from .tensor import input_tensor, nanreduce

    if not callable(func):
        red = nanreduce(func)
        func = lambda v: red(v, axis=-1)  # noqa: E731
    elif group_chunk is None:
        # an arbitrary callable may couple groups (e.g. normalize by a
        # cross-group max), so it gets the full gather unless the caller
        # opts into chunking explicitly
        group_chunk = 1 << 62

    gi = self.indexes(da.time)
    if self.add_dims and not main_only:
        from ..models._wrap import fold_add_dims

        (x,), bdims_f, bcoords_f, n_add = fold_add_dims(self, da)
        gi = gi.expand(n_add)
        _, out = _apply_func_chunked(x, gi, func, group_chunk, allow_transform=False)
        prop = self.prop_name if gi.prop != "group" else "group"
        coords = dict(bcoords_f)
        coords[prop] = gi.coord
        return DataArray(out, bdims_f + (prop,), coords, dict(da.attrs), da.name)
    dac = da.move_dim_last("time")
    x = input_tensor(dac.data)
    kind, out = _apply_func_chunked(x, gi, func, group_chunk)
    if kind == "transform":
        return DataArray(out, dac.dims, dict(dac.coords), dict(da.attrs), da.name)
    prop = self.prop_name if gi.prop != "group" else "group"
    bdims = dac.dims[:-1]
    coords = {d: dac.coords[d] for d in bdims if d in dac.coords}
    coords[prop] = gi.coord
    return DataArray(out, bdims + (prop,), coords, dict(da.attrs), da.name)


Grouper.apply = _grouper_apply
