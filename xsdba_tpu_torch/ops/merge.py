"""Windowed-group merge: the row sort, the dyadic level build and the window fold.

The port of ``xsdba_tpu/ops/pallas/merge_kernel.py``, the merge engine of the
windowed grouped quantile (``ops/quantile.py:windowed_group_quantile``).
Each group's window list is the union of ``window`` consecutive per-group
lists, so every list is sorted once (the row sort) and each group merges its
window's sorted lists instead of re-sorting the window-fold amplified gather.
For ``window >= 9`` the lists are first merged into aligned dyadic runs of
2, 4, ..., 2^L rows shared by the overlapping windows (the level build), and
each group folds its window's few aligned segments (the window fold); below
that each group merges its ``window`` rows directly.

Slab layout (as the TPU kernels exchange it): [B, Dp, m] rows of m values,
+inf past their data and never NaN; after the row sort even rows ascend and
odd rows descend.  Levels: [B, L, Dp, m], level k holding every aligned
2^(k+1)-row run as one ascending run (not sign-stored as on the TPU).
Merged rows: [B, G, window * ymax], ascending, +inf past the data.

Order.  Every row, level and merged row is ordered by IEEE totalOrder, so
-0.0 lies below +0.0, as the Pallas kernels' min/max networks order them.
Equal values are then equal bit patterns, and every kernel and twin gives
one output by bit pattern: a quantile that falls on a zero takes the sign
the reference's kernels give it.

Every kernel has a plain PyTorch twin beside its wrapper.  A wrapper runs
the twin on a CPU tensor and launches its CUDA kernel
(``csrc/merge_kernel.cu``) on a CUDA tensor, or raises; nothing on a CUDA
tensor goes to a twin.  Three kernels have two variants each, chosen by the
wrapper from the shape alone: the row sort sorts a row of up to 1024 values
in one warp's registers (:func:`row_sort_in_warp`), a longer one in a
block's shared memory; the level build merges in shared memory when its two
buffers fit (:func:`levels_in_shared`), else in device memory; and the fold
keeps its second buffer in shared memory when it fits
(:func:`fold_scratch_in_shared`), else in its output row.
``launches`` counts the kernel launches of each wrapper (one a call each,
the level build included: every level in one launch; reset by assignment).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda import _build

__all__ = [
    "MAX_SEGMENTS",
    "alternate_row_directions",
    "build_levels",
    "build_levels_reference",
    "dyadic_segments",
    "fold_scratch_in_shared",
    "fold_smem_limit",
    "fold_windows",
    "fold_windows_reference",
    "launches",
    "levels_in_shared",
    "merged_window_rows",
    "merged_window_rows_reference",
    "n_levels",
    "row_sort_in_warp",
    "sort_rows_alternating",
    "sort_rows_alternating_reference",
    "total_order_sort",
]

#: kernel launches made by each wrapper (reset by assignment)
launches = {"sort_rows_alternating": 0, "build_levels": 0, "fold_windows": 0, "merged_window_rows": 0}

#: most dyadic segments one window may split into (``kMaxSegments`` in the source)
MAX_SEGMENTS = 64
#: the long-row sort holds one row in (static-limit) shared memory
_SORT_MAX_BYTES = 48 * 1024
#: the warp row sort: at most 32 values a lane (``kWarpSortMax`` in the source)
_WARP_SORT_MAX = 32 * 32
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "xsdba_sort_rows_alt": ([_P, _P, _LL, _I, _I, _I, _I, _I, _P], _I),
    "xsdba_build_levels": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "xsdba_fold_windows": ([_P, _P, _P] + [_I] * 10 + [_P], _I),
    "xsdba_fold_smem_limit": ([_I, _I], _LL),
}


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def n_levels(window: int) -> int:
    """Levels the shared fold builds for ``window``: runs of up to
    2^L = min(max(next_pow2(window) / 2, 8), 16) rows (the TPU kernel's class
    modulus, ``merge_kernel.py:720``); 4 at window 31."""
    classes = min(max(_next_pow2(window) // 2, 8), 16)
    return classes.bit_length() - 1


def alternate_row_directions(s, dim: int = -2):
    """Flip the odd rows (along ``dim``) of ascending-sorted lists to
    descending (reference ``merge_kernel.py:202``)."""
    odd = torch.arange(s.shape[dim], device=s.device) % 2 == 1
    shape = [1] * s.ndim
    shape[dim] = s.shape[dim]
    return torch.where(odd.reshape(shape), torch.flip(s, dims=(-1,)), s)


def dyadic_segments(c: int, window: int, max_rows: int):
    """Aligned dyadic segments of rows [c, c + window): (delta, rows) pairs,
    each ``rows`` a power of two at most ``max_rows`` starting at a multiple
    of itself (reference ``merge_kernel.py:376``)."""
    segs = []
    p, end = c, c + window
    while p < end:
        size = 1
        while size * 2 <= max_rows and p % (size * 2) == 0 and p + size * 2 <= end:
            size *= 2
        segs.append((p - c, size))
        p += size
    return segs


# ------------------------------------------------------------------ twins


def _cut(merged, out_width: int):
    w = merged.shape[-1]
    if out_width <= w:
        return merged[..., :out_width].contiguous()
    pad = torch.full(merged.shape[:-1] + (out_width - w,), torch.inf, dtype=merged.dtype, device=merged.device)
    return torch.cat([merged, pad], dim=-1)


def _ordered_keys(x):
    """The bit patterns of float ``x`` as signed integers that order as IEEE
    totalOrder orders the floats (negatives' magnitude bits flipped: -0.0
    becomes -1, +0.0 stays 0).  The map is its own inverse."""
    bits = 8 * x.element_size()
    b = x.view(torch.int32 if bits == 32 else torch.int64)
    return b ^ ((b >> (bits - 1)) & ((1 << (bits - 1)) - 1))


def total_order_sort(x):
    """Each row of float ``x`` (last axis) sorted ascending by IEEE
    totalOrder: -0.0 before +0.0, so equal values are equal bit patterns."""
    return _ordered_keys(torch.sort(_ordered_keys(x), dim=-1).values).view(x.dtype)


def sort_rows_alternating_reference(x):
    """Twin of the row sort: :func:`total_order_sort` of each row, odd rows flipped."""
    return alternate_row_directions(total_order_sort(x))


def build_levels_reference(s, levels: int):
    """Twin of the level build: level k is :func:`total_order_sort` of each
    aligned 2^(k+1)-row run of the slab, stored ascending.  [B, Dp, m] -> [B, L, Dp, m]."""
    B, Dp, m = s.shape
    runs = [total_order_sort(s.reshape(B, Dp >> (k + 1), (2 << k) * m)).reshape(B, Dp, m) for k in range(levels)]
    return torch.stack(runs, dim=1)


def merged_window_rows_reference(s, window: int, n_groups: int, out_width: int | None = None):
    """Twin of the per-group merge (K4): :func:`total_order_sort` of group
    g's window rows [g, g + window), concatenated, cut at ``out_width``
    (default ``window * m``).  [B, Dp, m] -> [B, G, out_width]."""
    B, Dp, m = s.shape
    rows = torch.arange(n_groups, device=s.device)[:, None] + torch.arange(window, device=s.device)[None, :]
    merged = total_order_sort(s[:, rows, :].reshape(B, n_groups, window * m))
    return _cut(merged, window * m if out_width is None else out_width)


def fold_windows_reference(s, levels, window: int, n_groups: int, out_width: int | None = None):
    """Twin of the window fold: :func:`total_order_sort` of group g's aligned
    dyadic segments, read from the levels (a single row from the slab), cut
    at ``out_width`` (default ``window * m``).  Groups g ≡ c (mod 2^L) share
    one segment plan, so the twin runs one class at a time."""
    B, Dp, m = s.shape
    max_rows = 1 << levels.shape[1]
    out = torch.empty((B, n_groups, window * m), dtype=s.dtype, device=s.device)
    for c in range(min(max_rows, n_groups)):
        g = torch.arange(c, n_groups, max_rows, device=s.device)
        parts = []
        for delta, rows in dyadic_segments(c, window, max_rows):
            if rows == 1:
                parts.append(s[:, g + delta, :])
            else:
                idx = g[:, None] + delta + torch.arange(rows, device=s.device)[None, :]
                k = rows.bit_length() - 2
                parts.append(levels[:, k][:, idx, :].reshape(B, len(g), rows * m))
        out[:, c::max_rows] = total_order_sort(torch.cat(parts, dim=-1))
    return _cut(out, window * m if out_width is None else out_width)


# ------------------------------------------------------------------ kernels


def _library():
    return _build.library("merge_kernel", _SIGNATURES)


def _check_slab(s, what: str = "slab"):
    if s.ndim != 3:
        raise ValueError(f"{what} must be [B, Dp, m], got shape {tuple(s.shape)}")
    if s.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} must be float32 or float64, got {s.dtype}")
    if not s.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no merge kernel for device {s.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def row_sort_in_warp(m: int) -> bool:
    """Which row sort variant a row of ``m`` values takes: True for the warp
    sort (the row in one warp's registers, at most 32 values a lane, f32 or
    f64, without spilling: every slab the port builds, up to m = 1024),
    False for the long-row variant (one block a row, the row in shared
    memory)."""
    return m <= _WARP_SORT_MAX


def levels_in_shared(m: int, n_levels: int, elem_size: int, limit: int) -> bool:
    """Which level build variant a block of 2^``n_levels`` slab rows of
    ``m`` values takes: True when its two merge buffers fit in the ``limit``
    bytes of shared memory a block may take (the heavy path: 2 x 16 x 256 x 4
    bytes), False when they do not (f64, m = 1024: 256 KB) and the block
    merges in device memory instead."""
    return 2 * (m << n_levels) * elem_size <= limit


def sort_rows_alternating(x):
    """Row sort (K3): [B, Dp, m] (m a power of two, +inf pads, no NaN) ->
    each row sorted, ascending on even rows and descending on odd rows.
    Rows of up to 1024 values sort in a warp (:func:`row_sort_in_warp`)."""
    _check_slab(x)
    B, Dp, m = x.shape
    if m & (m - 1) or Dp % 2:
        raise ValueError(f"the row sort needs a power-of-two row length and an even row count, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return sort_rows_alternating_reference(x)
    if m * x.element_size() > _SORT_MAX_BYTES:
        raise ValueError(f"the row sort holds a row in {_SORT_MAX_BYTES} bytes of shared memory; m={m} of {x.dtype} is longer")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rc = _library().xsdba_sort_rows_alt(
        x.data_ptr(), out.data_ptr(), B * Dp, m, Dp, x.element_size(),
        int(row_sort_in_warp(m)), x.device.index, _stream(x),
    )
    _raise_on(rc, "sort_rows_alternating")
    launches["sort_rows_alternating"] += 1
    return out


def build_levels(s, levels: int):
    """Level build (K5): alternating-sorted slab [B, Dp, m] -> [B, L, Dp, m],
    level k every aligned 2^(k+1)-row run merged ascending (Dp a multiple of
    2^L).  One launch builds every level, in shared memory when the block's
    buffers fit (:func:`levels_in_shared`), else in device memory."""
    _check_slab(s)
    B, Dp, m = s.shape
    if levels < 1 or Dp % (1 << levels):
        raise ValueError(f"{levels} levels need a row count that is a multiple of {1 << max(levels, 0)}, got Dp={Dp}")
    if s.device.type == "cpu":
        return build_levels_reference(s, levels)
    out = torch.empty((B, levels, Dp, m), dtype=s.dtype, device=s.device)
    if out.numel() == 0:
        return out
    shared = levels_in_shared(m, levels, s.element_size(), fold_smem_limit(s.dtype, s.device))
    rc = _library().xsdba_build_levels(
        s.data_ptr(), out.data_ptr(), B, Dp, m, levels, s.element_size(), int(shared), s.device.index, _stream(s)
    )
    _raise_on(rc, "build_levels")
    launches["build_levels"] += 1
    return out


def _fold_args(s, window: int, n_groups: int, max_rows: int, ymax):
    B, Dp, m = s.shape
    ymax = m if ymax is None else int(ymax)
    if not 1 <= ymax <= m:
        raise ValueError(f"ymax must lie in [1, m={m}], got {ymax}")
    if window < 1 or n_groups < 1 or n_groups - 1 + window > Dp:
        raise ValueError(f"{n_groups} groups of window {window} need at least {n_groups - 1 + window} slab rows, got {Dp}")
    worst = max(len(dyadic_segments(c, window, max_rows)) for c in range(max_rows))
    if worst > MAX_SEGMENTS:
        raise ValueError(f"a window of {window} rows splits into {worst} segments, more than the fold's {MAX_SEGMENTS}")
    return ymax


def fold_scratch_in_shared(n_values: int, elem_size: int, limit: int) -> bool:
    """Which fold variant a row of ``n_values`` merged values takes: True
    when both merge buffers fit in the ``limit`` bytes of shared memory a
    block may take, False when only the staging buffer does (the second
    buffer is then the block's output row in device memory).  A row whose
    staging buffer alone does not fit is refused by the wrapper."""
    return 2 * n_values * elem_size <= limit


def fold_smem_limit(dtype, device) -> int:
    """Bytes of shared memory a fold block (or a level build block) may take
    on the CUDA ``device``."""
    device = torch.device(device)
    return _fold_smem_limit(torch.empty((), dtype=dtype).element_size(), 0 if device.index is None else device.index)


@functools.cache
def _fold_smem_limit(elem_size: int, index: int) -> int:
    limit = _library().xsdba_fold_smem_limit(elem_size, index)
    if limit < 0:
        raise RuntimeError(f"reading the fold's shared-memory limit failed: cudaError {-limit}")
    return limit


def _fold_launch(name: str, s, levels, window: int, n_groups: int, L: int, ymax: int):
    B, Dp, m = s.shape
    out = torch.empty((B, n_groups, window * ymax), dtype=s.dtype, device=s.device)
    if out.numel() == 0:
        return out
    need = window * ymax * s.element_size()
    limit = fold_smem_limit(s.dtype, s.device)
    if need > limit:
        raise ValueError(
            f"{name}: a window of {window} rows of {ymax} values needs {need} bytes of shared memory, "
            f"more than the {limit} a block may take on {torch.cuda.get_device_name(s.device)}"
        )
    rc = _library().xsdba_fold_windows(
        s.data_ptr(), 0 if levels is None else levels.data_ptr(), out.data_ptr(),
        B, Dp, m, L, window, n_groups, ymax, s.element_size(),
        int(fold_scratch_in_shared(window * ymax, s.element_size(), limit)), s.device.index, _stream(s),
    )
    _raise_on(rc, name)
    launches[name] += 1
    return out


def fold_windows(s, levels, window: int, n_groups: int, ymax: int | None = None):
    """Window fold (K6): for each (row b, group g), merge the aligned dyadic
    segments of slab rows [g, g + window) (at most 2^L rows each, taken from
    ``levels`` [B, L, Dp, m], single rows from the slab) into one ascending
    row of ``window * ymax`` values.  ``ymax`` (default m) promises at most
    that many non-+inf values a slab row.  -> [B, n_groups, window * ymax]."""
    _check_slab(s)
    if levels.ndim != 4 or levels.shape[0] != s.shape[0] or tuple(levels.shape[2:]) != tuple(s.shape[1:]):
        raise ValueError(f"levels must be [B, L, Dp, m] over the slab {tuple(s.shape)}, got {tuple(levels.shape)}")
    if levels.dtype != s.dtype or levels.device != s.device or not levels.is_contiguous():
        raise ValueError("levels must be contiguous, of the slab's dtype and on its device")
    L = levels.shape[1]
    ymax = _fold_args(s, window, n_groups, 1 << L, ymax)
    if s.device.type == "cpu":
        return fold_windows_reference(s, levels, window, n_groups, window * ymax)
    return _fold_launch("fold_windows", s, levels, window, n_groups, L, ymax)


def merged_window_rows(s, window: int, n_groups: int, ymax: int | None = None):
    """Per-group merge (K4, used below window 9): for each (row b, group g),
    merge slab rows [g, g + window) into one ascending row of
    ``window * ymax`` values.  The window fold's kernel with every segment
    one slab row and no levels."""
    _check_slab(s)
    ymax = _fold_args(s, window, n_groups, 1, ymax)
    if s.device.type == "cpu":
        return merged_window_rows_reference(s, window, n_groups, window * ymax)
    return _fold_launch("merged_window_rows", s, None, window, n_groups, 0, ymax)
