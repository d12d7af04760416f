"""Key–payload row sort: stage 1 of the counting-selection windowed quantile.

The port of ``xsdba_tpu/ops/pallas/sort_kernel.py:sort_rows_with_payload``
(K7).  Each row of ``key`` [B, T] f32 is sorted ascending and the int32
payload ``lab`` [B, T] follows the same permutation.  T is padded with
(+inf, 0) to ``padded_length(T)``, a power-of-two multiple of 128, as the
reference pads it, and the padded rows are returned.  Keys must be NaN-free:
the caller maps a NaN key to (+inf, payload 0) (``ops/selquant.py``).  The
order of equal keys (and of -0.0 against +0.0) is free: the consumer reads
only the multiset of (key, payload) pairs.

On a CPU tensor :func:`sort_rows_with_payload` runs the plain twin
:func:`sort_rows_with_payload_reference`; on a CUDA tensor it launches the
kernel of ``csrc/sort_kernel.cu`` or raises: a radix sort of tiles of
``TILE`` pairs in shared memory, then ``merge_passes(Tp)`` merge-path passes.
``launches`` counts the kernel launches (``launch_count``: one tile sort and
one per merge pass; reset by assignment).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda import _build

__all__ = [
    "TILE",
    "key_bits_reference",
    "launch_count",
    "launches",
    "merge_passes",
    "padded_length",
    "sort_rows_with_payload",
    "sort_rows_with_payload_reference",
]

#: kernel launches made by :func:`sort_rows_with_payload` (reset by assignment)
launches = 0

#: pairs one block radix-sorts in shared memory (``kTile`` in the source)
TILE = 16384
#: longest padded row the kernel takes (``interval_membership`` refuses T >= 2^22)
MAX_LENGTH = 1 << 22
_LANES = 128
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"xsdba_sort_rows_with_payload": ([_P] * 6 + [_I] * 4 + [_P], _I)}


def padded_length(T: int) -> int:
    """The reference's padded row length: 128 times the next power of two
    of ``ceil(T / 128)`` (``sort_kernel.py:144-146``)."""
    rows = 1
    while rows * _LANES < T:
        rows *= 2
    return rows * _LANES


def merge_passes(Tp: int) -> int:
    """Merge passes after the tile sort for a padded row of ``Tp``:
    log2(Tp / TILE), 0 when a row fits in one tile."""
    return max(Tp // TILE, 1).bit_length() - 1


def launch_count(B: int, T: int) -> int:
    """Kernel launches of one call on [B, T]: one tile sort and one launch
    per merge pass, none when B is 0."""
    return 0 if B == 0 else 1 + merge_passes(padded_length(T))


def key_bits_reference(key):
    """Twin of the kernel's order-preserving key map: each float32 of
    ``key`` as the uint32 image that orders as the floats do (the sign bit
    flipped for non-negatives, every bit for negatives), held in int64.
    -0.0 maps just below +0.0."""
    bits = key.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= 1 << 31, bits ^ 0xFFFFFFFF, bits ^ 0x80000000)


def _pad(key, lab):
    B, T = key.shape
    Tp = padded_length(T)
    if Tp == T:
        return key, lab
    pad_k = torch.full((B, Tp - T), torch.inf, dtype=key.dtype, device=key.device)
    pad_l = torch.zeros((B, Tp - T), dtype=lab.dtype, device=lab.device)
    return torch.cat([key, pad_k], dim=1), torch.cat([lab, pad_l], dim=1)


def sort_rows_with_payload_reference(key, lab):
    """The kernel's plain twin: pad, a stable ``torch.sort`` of the keys and
    a ``torch.gather`` of the payload (any device)."""
    key, lab = _pad(key, lab)
    keys, order = torch.sort(key, dim=1, stable=True)
    return keys, torch.gather(lab, 1, order)


def _check(key, lab):
    if key.ndim != 2 or lab.shape != key.shape:
        raise ValueError(f"key and lab must be [B, T] of one shape, got {tuple(key.shape)} and {tuple(lab.shape)}")
    if key.dtype != torch.float32 or lab.dtype != torch.int32:
        raise TypeError(f"key must be float32 and lab int32, got {key.dtype} and {lab.dtype}")
    if key.device != lab.device:
        raise ValueError("key and lab must lie on one device")
    if key.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no sort kernel for device {key.device}")
    if padded_length(key.shape[1]) > MAX_LENGTH:
        raise ValueError(f"rows of up to {MAX_LENGTH} padded values, got T={key.shape[1]}")


def sort_rows_with_payload(key, lab):
    """Sort each row of ``key`` [B, T] (float32, NaN-free) ascending, the
    int32 payload ``lab`` [B, T] following the same permutation.  Returns
    (keys, payload), each [B, Tp] with Tp = ``padded_length(T)``, the pads
    (+inf, 0)."""
    global launches
    _check(key, lab)
    if key.device.type == "cpu":
        return sort_rows_with_payload_reference(key, lab)
    B, T = key.shape
    Tp = padded_length(T)
    key, lab = key.contiguous(), lab.contiguous()
    out_k = torch.empty((B, Tp), dtype=key.dtype, device=key.device)
    out_l = torch.empty((B, Tp), dtype=lab.dtype, device=lab.device)
    if B == 0:
        return out_k, out_l
    passes = merge_passes(Tp)
    tmp_k = torch.empty_like(out_k) if passes else out_k
    tmp_l = torch.empty_like(out_l) if passes else out_l
    stream = torch.cuda.current_stream(key.device).cuda_stream
    rc = _build.library("sort_kernel", _SIGNATURES).xsdba_sort_rows_with_payload(
        key.data_ptr(), lab.data_ptr(), out_k.data_ptr(), out_l.data_ptr(), tmp_k.data_ptr(), tmp_l.data_ptr(),
        B, T, Tp, key.device.index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"sort_rows_with_payload kernel launch failed: cudaError {rc}")
    launches += launch_count(B, T)
    return out_k, out_l
