"""CUDA fused multiply-add: ``fma(a, b, c) = a * b + c`` rounded once.

The JAX package's compiled programs get this rounding from XLA, which
contracts ``x * y + z`` on its CPU backend (the type-7 virtual index, the
quantile lerp, the lookup's interpolation and bracket blend), so the port
rounds those once too, through :func:`fma`, on every device.  On a CUDA
tensor that is this module's hand-written elementwise kernel
(``csrc/fma_kernel.cu``): one ``__fmaf_rn`` (float32) or ``__fma_rn``
(float64) a value.  It has no TPU counterpart.  Its plain twin is the exact
emulation ``utils/tensor.py:fma_emulated`` (some eighteen float64 passes),
which is also the CPU path.  Bound: bytes, three reads and one write a
value.  Operands that differ in dtype or device are refused on the CPU as
on the card.

:func:`layout` coalesces the broadcast on the host and picks the kernel:
``"rows"`` (one or two dimensions, fewer than 2^31 values: 16-byte vectors
along the flat output, a repeating operand read at row * s0 + col * s1) or
``"strided"`` (any other layout, one value a thread).  Importing this
module needs neither ``nvcc`` nor a GPU: the source is compiled at the
first CUDA call (:mod:`._build`) and bound with ``ctypes``.  A CPU tensor
takes the twin; a CUDA tensor launches the kernel or raises.  ``launches``
counts the kernel launches (reset it by assignment).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...utils.tensor import fma_emulated
from . import _build

__all__ = ["MAX_DIMS", "Layout", "fma", "fma_reference", "launches", "layout"]

#: kernel launches made by :func:`fma` (reset it by assignment)
launches = 0
#: most dimensions of the coalesced output (``kMaxDims`` in the source)
MAX_DIMS = 8
# the rows kernel indexes the flat output in 32 bits
_ROWS_LIMIT = 2**31 - 1
_SIGNATURES = {
    "xsdba_fma": (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    )
}


class Layout(NamedTuple):
    """The coalesced broadcast of ``fma``'s three operands."""

    path: str        #: "rows" or "strided", the kernel that serves it
    shape: tuple     #: the output's coalesced dimensions (at least one)
    strides: tuple   #: (a's, b's, c's) strides in elements along ``shape``
    dense: tuple     #: per operand: the rows kernel reads it in 16-byte vectors at the flat index


def layout(a, b, c) -> Layout:
    """How :func:`fma` reads ``a``, ``b`` and ``c``: their broadcast with
    size-1 dimensions dropped and adjacent dimensions merged wherever all
    three operands' strides allow it (each stride of the outer equals the
    inner's times its size), so that every output index addresses the same
    elements as before.  An operand is dense when its offset is the flat
    output index itself and its first element is 16-byte aligned."""
    ops = (a, b, c)
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape, c.shape))
    nd = len(shape)
    full = []
    for t in ops:
        lead = nd - t.dim()
        full.append([0] * lead + [s if n != 1 else 0 for n, s in zip(t.shape, t.stride())])
    keep = [d for d in range(nd) if shape[d] != 1]
    dims = [shape[d] for d in keep]
    strides = [[s[d] for d in keep] for s in full]
    d = len(dims) - 1
    while d > 0:
        if all(s[d - 1] == s[d] * dims[d] for s in strides):
            dims[d - 1 : d + 1] = [dims[d - 1] * dims[d]]
            for s in strides:
                del s[d - 1]
        d -= 1
    if not dims:
        dims, strides = [1], [[0] for _ in ops]
    n = 1
    for x in dims:
        n *= x
    if len(dims) <= 2 and n <= _ROWS_LIMIT:
        P = dims[-1]
        dense = tuple(
            s[-1] == 1 and (len(dims) == 1 or s[0] == P) and t.data_ptr() % 16 == 0 for s, t in zip(strides, ops)
        )
        return Layout("rows", tuple(dims), tuple(tuple(s) for s in strides), dense)
    return Layout("strided", tuple(dims), tuple(tuple(s) for s in strides), (False,) * 3)


def fma_reference(a, b, c):
    """The kernel's plain twin: the exact emulation (any device)."""
    return fma_emulated(a, b, c)


def fma(a, b, c):
    """``a * b + c`` rounded once, broadcasting the three tensors against
    each other: float32 or float64, all of one dtype and on one device."""
    global launches
    if not (a.dtype == b.dtype == c.dtype) or a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"a, b, c must share float32 or float64, got {a.dtype}, {b.dtype}, {c.dtype}")
    if not (a.device == b.device == c.device):
        raise ValueError(f"a, b, c must lie on one device, got {a.device}, {b.device}, {c.device}")
    if a.device.type != "cuda":
        return fma_reference(a, b, c)
    lay = layout(a, b, c)
    out = torch.empty(torch.broadcast_shapes(a.shape, b.shape, c.shape), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    nd = len(lay.shape)
    if nd > MAX_DIMS:
        raise ValueError(f"the fma kernel reads up to {MAX_DIMS} coalesced dimensions, got {lay.shape}")
    packed = (ctypes.c_longlong * (4 * nd))(*lay.shape, *lay.strides[0], *lay.strides[1], *lay.strides[2])
    rc = _build.library("fma_kernel", _SIGNATURES).xsdba_fma(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), out.numel(), int(a.dtype == torch.float64),
        int(lay.path == "strided"), nd, packed, sum(1 << k for k, d in enumerate(lay.dense) if d),
        a.device.index, torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"xsdba_fma kernel launch failed: cudaError {rc}")
    launches += 1
    return out
