"""Dense emission: stages 2b and 3 of the selection engine's emit mode.

Given each row's sorted values and packed labels [B, Tp] (stage 1), the
members of each group before every chunk of ``chunk`` elements
(``clo`` [B, nchunk, G], from stage 2a's block counts) and the needed
member ranks (``r_left``, ``r_right`` [B, G, nq], non-decreasing along nq;
``n`` [B, G] the valid counts), :func:`emit` returns the value of each
needed rank: ``left``, ``right`` [B, G, nq] and ``maxv`` [B, G], the value
of rank n (the group's largest valid value, the NaN-range clip's).  A rank
no element reaches (a group with no valid value) reads 0.

The JAX package computes this in plain JAX (``xsdba_tpu/ops/selquant.py``
``_window`` / ``_run`` / ``_chunk_emit`` / ``_assemble``): every element of
a chunk tests its member rank against ``slots`` ranks a group, [B, E, G, S]
hit tensors summed over the chunk, rerun at S = nq when a chunk needs more
than ``slots`` ranks.  :func:`emit_reference` is that form in PyTorch, its
hit tensors cut over sites and groups so that none exceeds ``_HIT_BUDGET``
elements; it is the CPU path and the twin the kernel is held to.  On a
CUDA tensor :func:`emit` launches ``csrc/emit_kernel.cu`` instead, which
stores no hit tensor and ignores ``slots``: it keeps a tile's membership
as bit masks a group in shared memory, built from two toggles a value and
a prefix XOR along the groups, and resolves the needed ranks a thread a
rank (its comment has the design); a failed build or launch raises.  Both
return a selected -0.0 as +0.0, as the JAX form's sums do.  ``launches`` counts the kernel launches (reset it
by assignment).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import profiling
from . import _build

__all__ = ["emit", "emit_reference", "launches"]

#: kernel launches made by :func:`emit` (reset it by assignment)
launches = 0
#: most elements of one hit tensor of the twin ([sites, chunk, groups, slots])
_HIT_BUDGET = 1 << 27
# labels are packed as start * _PACK + length (ops/selquant.py)
_PACK = 1024
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"xsdba_emit": ([_P] * 9 + [_I] * 7 + [_P], _I)}


def _check(svals, slab, clo, r_left, r_right, n, chunk):
    if svals.ndim != 2 or r_left.ndim != 3:
        raise ValueError(f"svals must be [B, Tp] and r_left [B, G, nq], got {tuple(svals.shape)} and {tuple(r_left.shape)}")
    B, Tp = svals.shape
    G, nq = r_left.shape[1:]
    if svals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"svals must be float32 or float64, got {svals.dtype}")
    if any(t.dtype != torch.int32 for t in (slab, clo, r_left, r_right, n)):
        raise TypeError("slab, clo, r_left, r_right and n must be int32")
    if chunk < 1 or Tp % chunk:
        raise ValueError(f"chunk {chunk} must divide the row length {Tp}")
    shapes = {"slab": (slab, (B, Tp)), "clo": (clo, (B, Tp // chunk, G)), "r_left": (r_left, (B, G, nq)), "r_right": (r_right, (B, G, nq)), "n": (n, (B, G))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    if len({t.device for t in (svals, slab, clo, r_left, r_right, n)}) != 1:
        raise ValueError("every operand must lie on one device")
    if not 1 <= G < _PACK:
        raise ValueError(f"1 <= G < {_PACK} groups, got {G}")


def emit(svals, slab, clo, r_left, r_right, n, chunk: int, slots: int = 32):
    """(left, right, maxv): the values of the needed ranks (module doc).

    ``svals`` [B, Tp] float32 or float64 and ``slab`` [B, Tp] int32 are the
    sorted rows, ``chunk`` divides Tp.  A CPU tensor takes
    :func:`emit_reference` with its ``slots``; a CUDA tensor launches the
    kernel, which needs no slots."""
    global launches
    _check(svals, slab, clo, r_left, r_right, n, chunk)
    if svals.device.type != "cuda":
        return emit_reference(svals, slab, clo, r_left, r_right, n, chunk, slots)
    B, Tp = svals.shape
    G, nq = r_left.shape[1:]
    args = [t.contiguous() for t in (svals, slab, clo, r_left, r_right, n)]
    left = torch.zeros((B, G, nq), dtype=svals.dtype, device=svals.device)
    right = torch.zeros_like(left)
    maxv = torch.zeros((B, G), dtype=svals.dtype, device=svals.device)
    if B == 0 or Tp == 0:
        return left, right, maxv
    rc = _build.library("emit_kernel", _SIGNATURES).xsdba_emit(
        *(t.data_ptr() for t in args), left.data_ptr(), right.data_ptr(), maxv.data_ptr(),
        B, Tp, chunk, G, nq, int(svals.dtype == torch.float64), svals.device.index,
        torch.cuda.current_stream(svals.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"xsdba_emit kernel launch failed: cudaError {rc}")
    launches += 1
    return left, right, maxv


def _windows(rk, clo, chi):
    """Per (row, chunk, group): the needed ranks at or before the chunk's
    start (``kb``, the first slot's index into ``rk``) and inside it."""
    kb = torch.sum(rk[:, None] <= clo[..., None], dim=-1, dtype=torch.int32)
    inside = torch.sum(rk[:, None] <= chi[..., None], dim=-1, dtype=torch.int32) - kb
    return kb, inside


def _slots(rk, kb, S):
    """rho [b, C, g, S]: the S ranks from kb on, 0 past the list's end."""
    idx = kb[..., None] + torch.arange(S, dtype=torch.int32, device=rk.device)
    nq = rk.shape[-1]
    rho = torch.gather(rk[:, None].expand(-1, kb.shape[1], -1, -1), 3, idx.clamp(max=nq - 1).long())
    return torch.where(idx < nq, rho, 0)


def _assemble(rk, kb, acc, clo):
    """The value of each rank of ``rk`` [b, g, nq] from the per-(chunk,
    slot) sums ``acc`` [b, C, g, S]: the chunk that holds the rank (the
    last whose start count is below it), then its slot."""
    b, C, g, S = acc.shape
    cc = torch.sum(clo[..., None] < rk[:, None], dim=1, dtype=torch.int32) - 1          # [b, g, nq]
    kb_at = torch.gather(kb.transpose(1, 2), 2, cc.long())                                # [b, g, nq]
    slot = torch.arange(rk.shape[-1], dtype=torch.int32, device=rk.device) - kb_at
    ok = (slot >= 0) & (slot < S)
    flat = (cc * S + slot.clamp(0, S - 1)).long()
    val = torch.gather(acc.permute(0, 2, 1, 3).reshape(b, g, C * S), 2, flat)
    return torch.where(ok, val, 0) + 0


def emit_reference(svals, slab, clo, r_left, r_right, n, chunk: int, slots: int = 32):
    """The kernel's plain twin, the JAX package's dense emission in PyTorch
    (any device): ``slots`` rank slots a (chunk, group), rerun at nq slots
    when a chunk needs more; sites and groups taken in pieces whose hit
    tensor [sites, chunk, groups, slots] stays within ``_HIT_BUDGET``
    elements (at least one site and one group a piece)."""
    _check(svals, slab, clo, r_left, r_right, n, chunk)
    B, Tp = svals.shape
    G, nq = r_left.shape[1:]
    C = Tp // chunk
    dev = svals.device
    nmax = torch.clamp(n, min=1)
    chi = torch.cat([clo[:, 1:], n[:, None]], dim=1)                                      # [B, C, G]
    kbL, kbR = torch.empty_like(clo), torch.empty_like(clo)
    overflow = False
    sites = max(1, _HIT_BUDGET // max(C * G * nq, 1))
    for b0 in range(0, B, sites):
        bs = slice(b0, b0 + sites)
        for rk, kb in ((r_left, kbL), (r_right, kbR)):
            kb[bs], inside = _windows(rk[bs], clo[bs], chi[bs])
            if not overflow and inside.numel():
                profiling.count("sync.emit_overflow")
                overflow = int(inside.max()) > slots
    S = nq if overflow or slots >= nq else slots
    left = torch.zeros((B, G, nq), dtype=svals.dtype, device=dev)
    right = torch.zeros_like(left)
    maxv = torch.zeros((B, G), dtype=svals.dtype, device=dev)
    if B == 0 or nq == 0 or C == 0:
        return left, right, maxv + 0
    g_iota = torch.arange(G, dtype=torch.int32, device=dev)
    groups = max(1, min(G, _HIT_BUDGET // (chunk * S)))
    sites = max(1, _HIT_BUDGET // (chunk * groups * S))
    for b0 in range(0, B, sites):
        for g0 in range(0, G, groups):
            bs, gs = slice(b0, b0 + sites), slice(g0, g0 + groups)
            rkL, rkR, clo_p = r_left[bs, gs], r_right[bs, gs], clo[bs, :, gs]
            rhoL, rhoR = _slots(rkL, kbL[bs, :, gs], S), _slots(rkR, kbR[bs, :, gs], S)     # [b, C, g, S]
            b, g = rkL.shape[:2]
            accL = torch.zeros((b, C, g, S), dtype=svals.dtype, device=dev)
            accR = torch.zeros_like(accL)
            accM = torch.zeros((b, g), dtype=svals.dtype, device=dev)
            for c in range(C):
                sv = svals[bs, c * chunk : (c + 1) * chunk]                                 # [b, E]
                sl = slab[bs, c * chunk : (c + 1) * chunk]
                d0 = g_iota[gs][None, None, :] - (sl // _PACK)[..., None]
                dd = d0 + torch.where(d0 < 0, G, 0)
                member = (dd < (sl % _PACK)[..., None]) & ~torch.isnan(sv)[..., None]       # [b, E, g]
                R = clo_p[:, c][:, None, :] + torch.cumsum(member, dim=1, dtype=torch.int32)
                R = torch.where(member, R, 0)                                               # rank 0 is never needed
                svw = sv[:, :, None, None]
                accL[:, c] = torch.sum(torch.where(R[..., None] == rhoL[:, c, None], svw, 0), dim=1)
                accR[:, c] = torch.sum(torch.where(R[..., None] == rhoR[:, c, None], svw, 0), dim=1)
                accM += torch.sum(torch.where(R == nmax[bs, gs][:, None, :], sv[..., None], 0), dim=1)
            left[bs, gs] = _assemble(rkL, kbL[bs, :, gs], accL, clo_p)
            right[bs, gs] = _assemble(rkR, kbR[bs, :, gs], accR, clo_p)
            maxv[bs, gs] = accM + 0
    return left, right, maxv
