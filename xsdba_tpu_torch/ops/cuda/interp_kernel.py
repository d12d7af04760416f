"""CUDA quantile-table lookup: the partitioned grouped adjust's kernel.

``interp_table_3d(v, xs, ys, nvalid)`` evaluates, for every partition row
``(b, g)``, that row's own compacted table at each of the row's values:
v [B, Gp, Lp] f32, xs/ys [B, Gp, nq] f32 (nq <= 64; valid nodes first and
ascending, then a +inf / NaN tail), nvalid [B, Gp] int32 -> [B, Gp, Lp] f32.
Linear interpolation, constant extrapolation, NaN for an empty table or a
NaN value.

It replaces ``xsdba_tpu/ops/pallas/interp_kernel.py:interp_table_pallas_3d``.
The lookup has to read and write ``v`` once (about 2 x 133 MB per call at
the [512, 14, 4650] headline partition) against a table of at most 128
floats per row, so its design keeps each row's table in shared memory and
streams the row's values through it, with nothing written back but the
result (``csrc/interp_kernel.cu``).  What bounds it on the card is not those
bytes but its locate step, a count loop over all nq nodes in shared memory:
on an H100 80GB HBM3 (700 W limit) it took 0.451 ms at the headline shape,
591 GB/s of ``v`` read and written.

The source is compiled with ``nvcc`` at the first CUDA call by the port's
shared build (:mod:`._build`) and bound with ``ctypes``.  Importing this
module needs neither ``nvcc`` nor a GPU.  A CPU tensor takes the plain twin
:func:`interp_table_3d_reference`; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["MAX_NQ", "interp_table_3d", "interp_table_3d_reference", "launches"]

#: kernel launches made by :func:`interp_table_3d` (reset it by assignment)
launches = 0

#: widest table the kernel takes (its shared-memory row, ``kMaxNq`` in the source)
MAX_NQ = 64
_SIGNATURES = {"xsdba_interp_table_3d": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int)}


def interp_table_3d_reference(v, xs, ys, nvalid):
    """The kernel's plain twin: ``_interp_unrolled`` linear/constant on the
    same arguments (any device)."""
    from ..interp import _interp_unrolled

    return _interp_unrolled(v, xs, ys, nvalid, "linear", "constant")


def _check(v, xs, ys, nvalid):
    if v.ndim != 3:
        raise ValueError(f"v must be [B, Gp, Lp], got shape {tuple(v.shape)}")
    B, Gp, _ = v.shape
    if xs.ndim != 3 or tuple(xs.shape[:2]) != (B, Gp) or xs.shape != ys.shape:
        raise ValueError(f"xs/ys must be [B, Gp, nq] matching v, got {tuple(xs.shape)} and {tuple(ys.shape)}")
    if tuple(nvalid.shape) != (B, Gp):
        raise ValueError(f"nvalid must be [B, Gp] = {(B, Gp)}, got {tuple(nvalid.shape)}")
    if not 1 <= xs.shape[-1] <= MAX_NQ:
        raise ValueError(f"tables of 1..{MAX_NQ} nodes only, got nq={xs.shape[-1]}")
    if v.dtype != torch.float32 or xs.dtype != torch.float32 or ys.dtype != torch.float32:
        raise TypeError(f"v, xs, ys must be float32, got {v.dtype}, {xs.dtype}, {ys.dtype}")
    if nvalid.dtype != torch.int32:
        raise TypeError(f"nvalid must be int32, got {nvalid.dtype}")
    if len({t.device for t in (v, xs, ys, nvalid)}) != 1:
        raise ValueError("v, xs, ys and nvalid must lie on one device")
    if not all(t.is_contiguous() for t in (v, xs, ys, nvalid)):
        raise ValueError("v, xs, ys and nvalid must be contiguous")
    if B * Gp >= 2**31 or v.shape[-1] >= 2**31:
        raise ValueError("more rows or values per row than the kernel indexes")


def interp_table_3d(v, xs, ys, nvalid):
    """Partition-layout lookup: v [B, Gp, Lp]; xs/ys [B, Gp, nq] compacted
    per-(batch, group) tables; nvalid [B, Gp] int32 -> [B, Gp, Lp]."""
    global launches
    _check(v, xs, ys, nvalid)
    if v.device.type == "cpu":
        return interp_table_3d_reference(v, xs, ys, nvalid)
    if v.device.type != "cuda":
        raise ValueError(f"no lookup kernel for device {v.device}")
    B, Gp, Lp = v.shape
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = _build.library("interp_kernel", _SIGNATURES).xsdba_interp_table_3d(
        v.data_ptr(), xs.data_ptr(), ys.data_ptr(), nvalid.data_ptr(), out.data_ptr(),
        B * Gp, Lp, xs.shape[-1], v.device.index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"interp_table_3d kernel launch failed: cudaError {rc}")
    launches += 1
    return out
