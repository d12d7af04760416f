"""Small tensor helpers shared by the containers and the ops.

Data arrives as numpy arrays or torch tensors.  A tensor stays on its device.
Inside the ops a numpy array becomes a tensor on the device it is asked for
(the CPU by default); numpy data entering through the public surface goes
to the ``device`` option's device (:func:`input_tensor`).
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from . import profiling

__all__ = [
    "as_tensor",
    "default_device",
    "fma_emulated",
    "full_float32_matmul",
    "input_tensor",
    "nanmax",
    "nanmin",
    "nanreduce",
    "nanstd",
    "nanvar",
    "numpy_dtype",
    "to_numpy",
    "upload",
]


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a tensor: tensors keep their device unless one is given,
    numpy arrays and scalars become tensors on ``device`` (CPU by default)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype or x.dtype, device=device or x.device)
    a = np.asarray(x)
    if not a.flags.writeable:  # read-only (broadcast views, loaded files): torch wants its own copy
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=device)


@contextmanager
def full_float32_matmul():
    """cuBLAS's float32 products in full float32 inside the block (TF32
    off), as the reference's run at HIGHEST precision; the setting is put
    back after it."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def upload(a, dtype=None, device=None, copy: bool = False) -> torch.Tensor:
    """A host array (numpy, or array-like) as a tensor on ``device`` (CPU by
    default), counted in the ``upload.arrays`` and ``upload.bytes``
    counters (the tensor's bytes, on every device; on CUDA a copy from
    pageable host memory).  ``copy`` makes the tensor its own copy on the
    CPU too (``torch.tensor``); otherwise a CPU tensor may share the
    array's memory (``torch.as_tensor``).  A tensor is not an upload: it is
    converted by :func:`as_tensor`, uncounted."""
    if isinstance(a, torch.Tensor):
        return as_tensor(a, dtype=dtype, device=device)
    out = torch.tensor(a, dtype=dtype, device=device) if copy else as_tensor(a, dtype=dtype, device=device)
    profiling.count("upload.arrays")
    profiling.count("upload.bytes", out.numel() * out.element_size())
    return out


def default_device() -> torch.device:
    """The ``device`` option as a device.  Raises a ``RuntimeError`` when it
    names CUDA and no GPU is available: nothing falls back to the CPU."""
    from .options import DEVICE, get_option

    dev = torch.device(get_option(DEVICE))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "xsdba_tpu_torch computes numpy inputs on CUDA by default, but torch.cuda.is_available() is False; "
            "ask for the CPU with xsdba_tpu_torch.set_options(device='cpu') or pass CPU tensors."
        )
    return dev


def input_tensor(x) -> torch.Tensor:
    """Data entering through the public surface as a tensor: a tensor keeps
    its device, anything else goes to :func:`default_device`."""
    if isinstance(x, torch.Tensor):
        return x
    return as_tensor(x, device=default_device())


def _two_sum(a, b):
    """(s, e): s = a + b rounded, and s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """(p, e): p = a * b rounded, and p + e == a * b exactly (float64;
    Dekker's product with Veltkamp's split)."""

    def split(x):
        t = 134217729.0 * x  # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    p = a * b
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_to_odd(s, e):
    """The sum s + e (s rounded, e its exact error) rounded to odd: s when
    exact or odd, else s's neighbour towards s + e.  A non-finite s has a
    NaN error and stays as it is."""
    inexact_even = (e.abs() > 0) & ((s.view(torch.int64) & 1) == 0)
    return torch.where(inexact_even, torch.nextafter(s, e * torch.inf), s)


def fma_emulated(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once, in plain tensor operations on any device,
    for float32 or float64 tensors of one dtype that broadcast against each
    other: the CPU path of ``ops/cuda/fma_kernel.py:fma`` and the plain twin
    of its CUDA kernel.

    Float32 goes through float64, where the product is exact and the sum,
    rounded to odd, rounds to float32 as the fused result would; float64
    uses Boldo and Melquiond's emulation through rounding to odd (exact
    while ``a * b`` neither overflows nor falls under 2^-969, where the
    product's error term leaves the float64 range), and a non-finite result
    there takes the plain expression.  A zero result takes the sign the
    fused operation gives it: that of a sum of signed zeros where a or b is
    zero, the rounded product's where only c is, +0 where a * b cancels c."""
    if a.dtype == torch.float32:
        return _round_to_odd(*_two_sum(a.double() * b.double(), c.double())).float()
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    out = th + _round_to_odd(*_two_sum(tl, ul))
    p = a * b
    zero = torch.where((a == 0) | (b == 0) | (c != 0), p + c, p)
    out = torch.where(out == 0, zero, out)
    return torch.where(torch.isfinite(out), out, p + c)


def _check_leading(values_lead, trained_lead) -> None:
    """Raise unless a value array's leading dims ``values_lead`` broadcast
    against a trained array's ``trained_lead``.  Both packages match them by
    position from the right (ROADMAP C25), so arrays trained on [site, time]
    fail against a ``stack_periods`` sim laid out as [site, period, time]:
    the ``ValueError`` (the JAX package's class) says how to lay sim out."""
    try:
        torch.broadcast_shapes(tuple(values_lead), tuple(trained_lead))
    except RuntimeError:
        raise ValueError(
            f"the trained arrays' leading dims {tuple(trained_lead)} do not broadcast against sim's {tuple(values_lead)}: "
            "they are matched by position from the right, so a sim stacked by stack_periods must have its period dim "
            'first, sim.transpose("period", ...)'
        ) from None


def to_numpy(x) -> np.ndarray:
    """Host numpy copy (or view) of a tensor or array-like; a tensor counts
    in ``sync.to_numpy``."""
    if isinstance(x, torch.Tensor):
        profiling.count("sync.to_numpy")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype matching a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _dims(x: torch.Tensor, axis):
    if axis is None:
        return tuple(range(x.ndim))
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _count(x: torch.Tensor, axis, keepdims: bool):
    return (~torch.isnan(x)).sum(dim=_dims(x, axis), keepdim=keepdims)


def nanmin(x: torch.Tensor, axis=None, keepdims: bool = False) -> torch.Tensor:
    """NaN-skipping minimum; all-NaN slices give NaN (as ``np.nanmin``)."""
    out = torch.where(torch.isnan(x), torch.inf, x).amin(dim=_dims(x, axis), keepdim=keepdims)
    return torch.where(_count(x, axis, keepdims) == 0, torch.nan, out)


def nanmax(x: torch.Tensor, axis=None, keepdims: bool = False) -> torch.Tensor:
    """NaN-skipping maximum; all-NaN slices give NaN (as ``np.nanmax``)."""
    out = torch.where(torch.isnan(x), -torch.inf, x).amax(dim=_dims(x, axis), keepdim=keepdims)
    return torch.where(_count(x, axis, keepdims) == 0, torch.nan, out)


def nanvar(x: torch.Tensor, axis=None, keepdims: bool = False, ddof: int = 0) -> torch.Tensor:
    """NaN-skipping variance (as ``np.nanvar``)."""
    dims = _dims(x, axis)
    mean = torch.nanmean(x, dim=dims, keepdim=True)
    sq = torch.nansum((x - mean) ** 2, dim=dims, keepdim=keepdims)
    return sq / (_count(x, axis, keepdims) - ddof).to(x.dtype)


def nanstd(x: torch.Tensor, axis=None, keepdims: bool = False, ddof: int = 0) -> torch.Tensor:
    """NaN-skipping standard deviation (as ``np.nanstd``)."""
    return torch.sqrt(nanvar(x, axis, keepdims, ddof))


def _nanmean(x, axis=None, keepdims=False):
    return torch.nanmean(x, dim=_dims(x, axis), keepdim=keepdims)


def _nansum(x, axis=None, keepdims=False):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdims)


_REDUCERS = {"mean": _nanmean, "sum": _nansum, "min": nanmin, "max": nanmax, "std": nanstd, "var": nanvar}


def nanreduce(name: str):
    """The NaN-skipping reduction ``name`` (mean/sum/min/max/std/var) for
    tensors, with numpy's ``(x, axis=...)`` signature."""
    return _REDUCERS[name]
