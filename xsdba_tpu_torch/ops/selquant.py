"""Host helpers of the counting-selection windowed quantile.

Only the two numpy functions the grouping lowering needs
(``utils.grouper._window_merge_plan``) live here so far: the inversion of a
gather matrix into per-element cyclic group intervals, and the packing of
those intervals into one int32 label.  The selection engine itself is still
to be ported (ROADMAP A4).
"""

from __future__ import annotations

import numpy as np

__all__ = ["interval_membership", "pack_labels"]

# labels are packed as start*_PACK + length; _PACK must exceed any group count
_PACK = 1024


def interval_membership(gather_idx, n_groups: int, T: int):
    """Host-side inversion of a [G, L] gather matrix into per-element cyclic
    group intervals, or None when membership is not interval-shaped.

    Returns ``(start, length)`` int32 arrays of shape [T]: element ``t`` is a
    member of groups ``{(start[t] + j) % G : j < length[t]}``.  Valid only
    when every element's member-group set is a single cyclic interval and the
    gather matrix holds no duplicate entries (both checked).  Rolling doy/5D
    windows on regular calendars pass; leap/standard calendars (the doy
    sequence skips a value in most years) fail and keep the merge path.
    """
    gi = np.asarray(gather_idx)
    G = int(n_groups)
    mem = np.zeros((T, G), dtype=bool)
    n_entries = 0
    for g in range(G):
        m = gi[g]
        m = m[m >= 0]
        n_entries += len(m)
        mem[m, g] = True
    if n_entries != int(mem.sum()):  # duplicate entries: counts would be off
        return None
    cnt = mem.sum(axis=1)
    starts01 = mem & ~np.roll(mem, 1, axis=1)
    ns = starts01.sum(axis=1)
    full = cnt == G
    if not np.all((ns == 1) | (cnt == 0) | full):
        return None
    start = np.argmax(starts01, axis=1).astype(np.int32)
    start[full | (cnt == 0)] = 0
    if G >= _PACK or T >= (1 << 22):  # packed label must fit int32 exactly
        return None
    return start, cnt.astype(np.int32)


def pack_labels(start, length) -> np.ndarray:
    """Pack host interval arrays into the single int32 label the core sorts."""
    return (np.asarray(start, np.int32) * _PACK + np.asarray(length, np.int32)).astype(
        np.int32
    )
