"""CUDA grouped rank: QDM's percent rank of sim in one launch.

``grouped_rank(x, gather_idx, group_idx, scatter_slot, pct)`` ranks every
value of x [..., T] within its (windowed) group, the ranks of group g being
those of ``x[..., gather_idx[g, :]]`` (ties averaged, ranks from 1, NaN and
-1 slots left out; with ``pct`` divided by the group's valid count and
rescaled to span [0, max], reference ``utils.py:631-634``), and writes each
back to time through ``(group_idx[t], scatter_slot[t])``: the function of
``ops/segment.py:grouped_rank``.  Its plain twin is
``ops/segment.py:grouped_rank_reference`` (a gather into a NaN-padded
[..., G, L] slab, one stable sort, two ``cummax`` scans, a scatter, the
rescale and a gather back: some 25 launches).  It replaces no TPU kernel.

The kernel (``csrc/rank_kernel.cu``) gives each (row, group) one block that
gathers the group's values through its index row, sorts their keys with
their slots in shared memory (an LSD radix sort over the bytes in which the
group's values differ), finds each tie run by comparing neighbours (a
binary search where a run crosses into another thread's range), rescales
with the twin's operations in the twin's order, and writes slot j
to ``out[..., gather_idx[g, j]]`` where that time step's own group and slot
are (g, j), so nothing of size [..., G, L] is made and ``out`` is written
once.  The kernel equals the twin bit for bit.  Bound: bytes, x read once
and the ranks written once.  Every time step must be some slot's: each
``Grouper`` lowering points ``(group_idx[t], scatter_slot[t])`` at a slot
holding t, and a time step that no slot claims is left unwritten.

A group of at most :data:`MAX_ROW` slots in float32 or float64 fits the
kernel's shared-memory plans (:func:`fits`); ``ops/segment.py:grouped_rank``
sends a CUDA tensor that fits here and everything else to the twin.  The
source is compiled with ``nvcc`` at the first CUDA call by the port's
shared build (:mod:`._build`) and bound with ``ctypes``; importing this
module needs neither ``nvcc`` nor a GPU.  A CPU tensor takes the twin; a
CUDA tensor launches the kernel or raises.  ``launches`` counts the kernel
launches (reset it by assignment).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.tensor import as_tensor
from . import _build

__all__ = ["MAX_ROW", "fits", "grouped_rank", "launches"]

#: kernel launches made by :func:`grouped_rank` (reset it by assignment)
launches = 0
#: the longest group (``gather_idx``'s row length) the kernel's plans hold
#: (``xsdba_grouped_rank_max_len`` in the source: 512 threads x 23 slots)
MAX_ROW = 512 * 23
_DTYPES = (torch.float32, torch.float64)
_SIGNATURES = {
    "xsdba_grouped_rank": (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p],
        ctypes.c_int,
    )
}


def fits(device_type: str, dtype, row_len: int) -> bool:
    """Whether the kernel serves a tensor of this device type and dtype
    whose groups have ``row_len`` slots: CUDA, float32 or float64, and
    1 to :data:`MAX_ROW` slots."""
    return device_type == "cuda" and dtype in _DTYPES and 0 < row_len <= MAX_ROW


def _index(a, device) -> torch.Tensor:
    return as_tensor(a, device=device).to(torch.int32).contiguous()


def grouped_rank(x, gather_idx, group_idx, scatter_slot, pct: bool = False):
    """Grouped (percent) ranks of x [..., T] written back to time:
    gather_idx [G, L], group_idx and scatter_slot [T] (see the module
    docstring)."""
    global launches
    x = as_tensor(x)
    if x.device.type == "cpu":
        from ..segment import grouped_rank_reference

        return grouped_rank_reference(x, gather_idx, group_idx, scatter_slot, pct)
    gather, group_of, slot_of = (_index(a, x.device) for a in (gather_idx, group_idx, scatter_slot))
    T = x.shape[-1]
    if gather.dim() != 2 or group_of.shape != (T,) or slot_of.shape != (T,):
        raise ValueError(f"gather_idx must be [G, L] and group_idx, scatter_slot [T] = [{T}], got "
                         f"{tuple(gather.shape)}, {tuple(group_of.shape)}, {tuple(slot_of.shape)}")
    G, L = gather.shape
    if not fits(x.device.type, x.dtype, L):
        raise ValueError(f"the rank kernel takes float32 or float64 groups of 1 to {MAX_ROW} slots on CUDA, "
                         f"got {x.dtype} groups of {L} on {x.device}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    rows = xc.numel() // T if T else 0
    if out.numel() == 0 or G == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.library("rank_kernel", _SIGNATURES).xsdba_grouped_rank(
        xc.data_ptr(), gather.data_ptr(), group_of.data_ptr(), slot_of.data_ptr(), out.data_ptr(),
        rows, T, G, L, int(bool(pct)), int(x.dtype == torch.float64), x.device.index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"xsdba_grouped_rank kernel launch failed: cudaError {rc}")
    launches += 1
    return out
