"""CUDA quantile-table lookup: the kernels of the adjust step.

``interp_table_3d(v, xs, ys, nvalid, method)`` evaluates, for every
partition row ``(b, g)``, that row's own compacted table at each of the
row's values: v [B, Gp, Lp] f32, xs/ys [B, Gp, nq] f32 (nq <= 64; valid
nodes first and ascending, then a +inf / NaN tail), nvalid [B, Gp] int32 ->
[B, Gp, Lp] f32.  ``method`` is ``"linear"`` (interpolation between the
bracketing nodes) or ``"nearest"`` (the nearer node's value, a tie taking
the lower one); constant extrapolation, NaN for an empty table or a NaN
value.  ``interp_table_2d(v, xs, ys, nvalid, method)`` is the same lookup
with one table per row of v [R, L] (xs/ys [R, nq], nvalid [R]), the
ungrouped adjust's and every rotation's of the multivariate schemes
(``ops/interp.py:interp1d_table``).  They replace
``xsdba_tpu/ops/pallas/interp_kernel.py:interp_table_pallas_3d`` (K1) and
``interp_table_pallas`` (K2); both launch one kernel, on rows.

``interp_bracketed(v, xs, ys, nvalid, g0, g1, w)`` is the grouped adjust's
blended lookup in one pass: v [B, T] f32, the cyclically padded compacted
tables xs/ys [B, Gp, nq] and nvalid [B, Gp], and per time step the two
bracketing padded groups g0, g1 [T] int32 and the weight w [T] f32 ->
``fma(1 - w, table_g0(v), w * table_g1(v))`` [B, T].  It stands in for the
partition route of the reference's ``interp_grouped_partitioned``
(``xsdba_tpu/ops/interp.py:409``: two partition gathers, two K1 calls, two
gathers back and the blend), a layout the TPU needed; a site's tables must
fit :data:`BRACKETED_SMEM_BUDGET` (:func:`bracketed_fits`).

A lookup has to read and write ``v`` once against tables of at most 128
floats, so the design (``csrc/interp_kernel.cu``) keeps the tables in shared
memory, locates each value by a branch-free binary search of seven
unrolled probes, moves long rows in 16-byte loads and stores around a scalar
head and tail (row starts are not 16-byte aligned), and gives rows of fewer
than :data:`SHORT_ROW` values a warp each, a value a lane a step.  The
bracketed kernel lays each site's tables out once a block for a search and
one load (the nodes and a sentinel above the last valid one in
breadth-first order, 6 probes for nq <= 62 and 7 above; a 16-byte segment
record a count of nodes), consecutive lanes take consecutive time steps,
and a thread looks up two of them a round in both their tables, its four
searches interleaved; a block serves one site over
:data:`BRACKETED_CHUNK` steps.
Device times on an NVIDIA H100 80GB HBM3 (700 W limit) are in ``PERF.md``,
section 6.

The source is compiled with ``nvcc`` at the first CUDA call by the port's
shared build (:mod:`._build`) and bound with ``ctypes``.  Importing this
module needs neither ``nvcc`` nor a GPU.  A CPU tensor takes the plain twin
(:func:`interp_table_3d_reference`, :func:`interp_table_2d_reference`,
:func:`interp_bracketed_reference`); a CUDA tensor launches the kernel or
raises.  ``launches``, ``launches_2d`` and ``launches_bracketed`` count the
kernel launches of each wrapper (reset them by assignment).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.tensor import fma_emulated
from . import _build

__all__ = [
    "BRACKETED_CHUNK",
    "BRACKETED_SMEM_BUDGET",
    "MAX_NQ",
    "METHODS",
    "SHORT_ROW",
    "bracketed_fits",
    "bracketed_smem_bytes",
    "interp_bracketed",
    "interp_bracketed_reference",
    "interp_table_2d",
    "interp_table_2d_reference",
    "interp_table_3d",
    "interp_table_3d_reference",
    "launches",
    "launches_2d",
    "launches_bracketed",
]

#: kernel launches made by :func:`interp_table_3d` (reset it by assignment)
launches = 0
#: kernel launches made by :func:`interp_table_2d` (reset it by assignment)
launches_2d = 0
#: kernel launches made by :func:`interp_bracketed` (reset it by assignment)
launches_bracketed = 0

#: widest table the kernel takes (its shared-memory row, ``kMaxNq`` in the source)
MAX_NQ = 64
#: rows of fewer values take one warp each (``kShortRow`` in the source)
SHORT_ROW = 1024
#: the bracketed route admits a site's tables while :func:`bracketed_smem_bytes`
#: fits this budget (``kBracketAdmitSmem`` in the source)
BRACKETED_SMEM_BUDGET = 48 * 1024
#: time steps a block of the bracketed kernel serves (``kBrChunk`` in the source)
BRACKETED_CHUNK = 8 * 1024
#: the row lookups' methods, as the C entries number them
METHODS = {"linear": 0, "nearest": 1}
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p], ctypes.c_int)
_SIGNATURES = {
    "xsdba_interp_table_3d": _ARGS,
    "xsdba_interp_table_2d": _ARGS,
    "xsdba_interp_bracketed": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p], ctypes.c_int),
}


def bracketed_smem_bytes(gp: int) -> int:
    """The bracketed route's count of shared memory for a site's ``gp``
    tables: 1056 bytes each whatever their width (``kBracketAdmitTable`` in
    the source), what a table took in the kernel's first layout (65 (x, y)
    pairs, 129 probe nodes, four constants and the valid count).  The route
    admits up to 46 tables a site by it.  The kernel's own layout takes
    16 (nq + 2) + 4 (2^depth + 1) bytes a table (1092 at nq = 50) and asks
    for more than 48 KB where a site's tables need it."""
    return gp * (16 + 8 * (MAX_NQ + 1) + 4 * (2 * MAX_NQ + 1) + 4)


def bracketed_fits(gp: int, nq: int) -> bool:
    """Whether a site's ``gp`` padded tables of ``nq`` nodes fit the
    bracketed kernel: 1 <= nq <= ``MAX_NQ`` and within
    ``BRACKETED_SMEM_BUDGET`` (46 tables)."""
    return gp >= 1 and 1 <= nq <= MAX_NQ and bracketed_smem_bytes(gp) <= BRACKETED_SMEM_BUDGET


def interp_table_3d_reference(v, xs, ys, nvalid, method: str = "linear"):
    """The kernel's plain twin: ``_interp_unrolled`` with ``method`` and
    constant extrapolation on the same arguments (any device)."""
    from ..interp import _interp_unrolled

    _check_method(method)
    return _interp_unrolled(v, xs, ys, nvalid, method, "constant")


def interp_table_2d_reference(v, xs, ys, nvalid, method: str = "linear"):
    """The 2-D kernel's plain twin: ``_interp_unrolled`` with ``method`` and
    constant extrapolation on the same arguments (any device)."""
    return interp_table_3d_reference(v, xs, ys, nvalid, method)


def _check_method(method: str):
    if method not in METHODS:
        raise ValueError(f"the lookup kernel serves the methods {sorted(METHODS)}, got {method!r}")


def _check(v, xs, ys, nvalid, method, names="B, Gp"):
    _check_method(method)
    rank = len(names.split(", ")) + 1
    if v.ndim != rank:
        raise ValueError(f"v must be [{names}, L], got shape {tuple(v.shape)}")
    lead = tuple(v.shape[:-1])
    if xs.ndim != rank or tuple(xs.shape[:-1]) != lead or xs.shape != ys.shape:
        raise ValueError(f"xs/ys must be [{names}, nq] matching v, got {tuple(xs.shape)} and {tuple(ys.shape)}")
    if tuple(nvalid.shape) != lead:
        raise ValueError(f"nvalid must be [{names}] = {lead}, got {tuple(nvalid.shape)}")
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
    if nvalid.numel() >= 2**31 or v.shape[-1] >= 2**31:
        raise ValueError("more rows or values per row than the kernel indexes")
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no lookup kernel for device {v.device}")


def _launch(entry: str, v, xs, ys, nvalid, method: str):
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = getattr(_build.library("interp_kernel", _SIGNATURES), entry)(
        v.data_ptr(), xs.data_ptr(), ys.data_ptr(), nvalid.data_ptr(), out.data_ptr(),
        nvalid.numel(), v.shape[-1], xs.shape[-1], METHODS[method], v.device.index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    return out


def interp_table_3d(v, xs, ys, nvalid, method: str = "linear"):
    """Partition-layout lookup (K1): v [B, Gp, Lp]; xs/ys [B, Gp, nq]
    compacted per-(batch, group) tables; nvalid [B, Gp] int32 -> [B, Gp, Lp];
    ``method`` "linear" or "nearest"."""
    global launches
    _check(v, xs, ys, nvalid, method)
    if v.device.type == "cpu":
        return interp_table_3d_reference(v, xs, ys, nvalid, method)
    out = _launch("xsdba_interp_table_3d", v, xs, ys, nvalid, method)
    launches += out.numel() > 0
    return out


def interp_table_2d(v, xs, ys, nvalid, method: str = "linear"):
    """Row lookup (K2): v [R, L]; xs/ys [R, nq] one compacted table per
    row; nvalid [R] int32 -> [R, L]; ``method`` "linear" or "nearest"."""
    global launches_2d
    _check(v, xs, ys, nvalid, method, names="R")
    if v.device.type == "cpu":
        return interp_table_2d_reference(v, xs, ys, nvalid, method)
    out = _launch("xsdba_interp_table_2d", v, xs, ys, nvalid, method)
    launches_2d += out.numel() > 0
    return out


def interp_bracketed_reference(v, xs, ys, nvalid, g0, g1, w):
    """The bracketed kernel's plain twin (any device): each time step's value
    evaluated with ``_interp_unrolled`` against the table of its group, once
    per bracket, and ``fma(1 - w, val0, w * val1)`` by the exact emulation.
    A group id outside [0, Gp) has no table and gives NaN."""
    from ..interp import _interp_unrolled

    def side(grp):
        out = torch.full_like(v, torch.nan)
        for g in range(xs.shape[-2]):
            at = torch.nonzero(grp == g)[:, 0]
            if at.numel():
                out[:, at] = _interp_unrolled(v[:, at], xs[:, g], ys[:, g], nvalid[:, g], "linear", "constant")
        return out

    return fma_emulated(1 - w, side(g0), w * side(g1))


def _check_bracketed(v, xs, ys, nvalid, g0, g1, w):
    if v.ndim != 2:
        raise ValueError(f"v must be [B, T], got shape {tuple(v.shape)}")
    B, T = v.shape
    if xs.ndim != 3 or xs.shape[0] != B or xs.shape != ys.shape:
        raise ValueError(f"xs/ys must be [B, Gp, nq] matching v, got {tuple(xs.shape)} and {tuple(ys.shape)}")
    Gp, nq = xs.shape[1:]
    if tuple(nvalid.shape) != (B, Gp):
        raise ValueError(f"nvalid must be [B, Gp] = {(B, Gp)}, got {tuple(nvalid.shape)}")
    if not (tuple(g0.shape) == tuple(g1.shape) == tuple(w.shape) == (T,)):
        raise ValueError(f"g0, g1 and w must be [T] = {(T,)}, got {tuple(g0.shape)}, {tuple(g1.shape)}, {tuple(w.shape)}")
    if not bracketed_fits(Gp, nq):
        raise ValueError(
            f"{Gp} tables of {nq} nodes need {bracketed_smem_bytes(Gp)} bytes of shared memory, "
            f"over the {BRACKETED_SMEM_BUDGET} of the bracketed kernel (nq <= {MAX_NQ}); take the partition route"
        )
    if not all(t.dtype == torch.float32 for t in (v, xs, ys, w)):
        raise TypeError(f"v, xs, ys, w must be float32, got {v.dtype}, {xs.dtype}, {ys.dtype}, {w.dtype}")
    if not all(t.dtype == torch.int32 for t in (nvalid, g0, g1)):
        raise TypeError(f"nvalid, g0, g1 must be int32, got {nvalid.dtype}, {g0.dtype}, {g1.dtype}")
    tensors = (v, xs, ys, nvalid, g0, g1, w)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("v, the tables and the brackets must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("v, the tables and the brackets must be contiguous")
    if T >= 2**31 or B >= 2**31:
        raise ValueError("more sites or time steps than the kernel indexes")
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no lookup kernel for device {v.device}")


def interp_bracketed(v, xs, ys, nvalid, g0, g1, w):
    """Blended bracket lookup: v [B, T]; xs/ys [B, Gp, nq] cyclically padded
    compacted tables; nvalid [B, Gp] int32; g0, g1 [T] int32 padded group
    ids; w [T] -> ``fma(1 - w, table_g0(v), w * table_g1(v))`` [B, T]."""
    global launches_bracketed
    _check_bracketed(v, xs, ys, nvalid, g0, g1, w)
    if v.device.type == "cpu":
        return interp_bracketed_reference(v, xs, ys, nvalid, g0, g1, w)
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = _build.library("interp_kernel", _SIGNATURES).xsdba_interp_bracketed(
        v.data_ptr(), xs.data_ptr(), ys.data_ptr(), nvalid.data_ptr(), g0.data_ptr(), g1.data_ptr(), w.data_ptr(),
        out.data_ptr(), v.shape[0], v.shape[1], xs.shape[1], xs.shape[2], v.device.index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"xsdba_interp_bracketed kernel launch failed: cudaError {rc}")
    launches_bracketed += 1
    return out
