"""CUDA fused multiply-add: ``fma(a, b, c) = a * b + c`` rounded once.

The JAX package's compiled programs get this rounding from XLA, which
contracts ``x * y + z`` on its CPU backend (the type-7 virtual index, the
quantile lerp, the lookup's interpolation and bracket blend), so the port
rounds those once too, through :func:`fma`, on every device.  On a CUDA
tensor that is this module's hand-written elementwise kernel
(``csrc/fma_kernel.cu``): one ``__fmaf_rn`` (float32) or ``__fma_rn``
(float64) a value, each operand read through its broadcast strides (0 along
a broadcast dimension).  It has no TPU counterpart.  Its plain twin is the
exact emulation ``utils/tensor.py:fma_emulated`` (some eighteen float64
passes), which is also the CPU path.  Bound: bytes, three reads and one
write a value.  Operands that differ in dtype or device are refused on the
CPU as on the card.

Importing this module needs neither ``nvcc`` nor a GPU: the source is
compiled at the first CUDA call (:mod:`._build`) and bound with ``ctypes``.
A CPU tensor takes the twin; a CUDA tensor launches the kernel or raises.
``launches`` counts the kernel launches (reset it by assignment).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.tensor import fma_emulated
from . import _build

__all__ = ["MAX_DIMS", "fma", "fma_reference", "launches"]

#: kernel launches made by :func:`fma` (reset it by assignment)
launches = 0
#: most dimensions of the broadcast output (``kMaxDims`` in the source)
MAX_DIMS = 8
_DIMS = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "xsdba_fma": (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [_DIMS] * 4
        + [ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    )
}


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
    shape = torch.broadcast_shapes(a.shape, b.shape, c.shape)
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    dims = tuple(shape) or (1,)
    if len(dims) > MAX_DIMS:
        raise ValueError(f"the fma kernel broadcasts up to {MAX_DIMS} dimensions, got shape {tuple(shape)}")
    array = lambda values: (ctypes.c_longlong * len(dims))(*values)  # noqa: E731
    strides = [array(t.expand(dims).stride()) for t in (a, b, c)]
    rc = _build.library("fma_kernel", _SIGNATURES).xsdba_fma(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), out.numel(), int(a.dtype == torch.float64),
        len(dims), array(dims), *strides, a.device.index, torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"xsdba_fma kernel launch failed: cudaError {rc}")
    launches += 1
    return out
