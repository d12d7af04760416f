"""Device-mesh scaling for bias adjustment, over ``torch.distributed``.

The reference parallelizes with dask blocks over spatial dims
(``base.py:563-726``, SURVEY §2.10): bias adjustment is embarrassingly
parallel over sites, with time kept whole per site (the reference enforces a
single chunk along the adjusted dim, ``adjustment.py:102-103``).

Here a rank is one process with one device, and a 1-D (or 2-D site × var)
``DeviceMesh`` spans the ranks of the default process group.  Inputs are
``DTensor``s partitioned over the site mesh dimension (:func:`shard_sites`);
each rank adjusts its own block of sites with the port's cores, so the
adjustment path has no collective.  Collectives appear only in the spatial
diagnostics (an all-gather of standardized site blocks, the reduced Gram of
the leading EOF) and in the multivariate rotation contracted over a var
dimension.  The backend is NCCL on CUDA (one rank a card) and gloo on the
CPU.  Launch N ranks with ``torchrun --nproc-per-node N``; a plain process
with no launcher and no process group forms a one-rank world.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..utils.tensor import as_tensor, default_device, full_float32_matmul

__all__ = [
    "site_mesh",
    "shard_sites",
    "sharded_first_eof",
    "sharded_pairwise_corr",
    "site_sharding",
    "SITE_AXIS",
    "VAR_AXIS",
]

SITE_AXIS = "site"
VAR_AXIS = "var"

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(devices) -> str:
    """The ranks' device type: ``devices`` is None (the port's ``device``
    option), a device type or a ``torch.device``."""
    kind = default_device().type if devices is None else torch.device(devices).type
    if kind not in _BACKENDS:
        raise ValueError(f"no process-group backend for device type {kind!r}; expected one of {sorted(_BACKENDS)}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "site_mesh on CUDA needs a GPU, but torch.cuda.is_available() is False; "
            "ask for the CPU with xsdba_tpu_torch.set_options(device='cpu') or site_mesh('cpu')."
        )
    return kind


def _join_world(kind: str) -> None:
    """Join the default process group: a launcher's (``torchrun`` sets
    ``RANK`` and ``WORLD_SIZE``), or a world of this process alone."""
    if dist.is_initialized():
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(_BACKENDS[kind])
    else:
        dist.init_process_group(_BACKENDS[kind], store=dist.HashStore(), rank=0, world_size=1)


def site_mesh(devices=None, n_var: int = 1) -> DeviceMesh:
    """Build a mesh over the site axis (optionally site x var) of the ranks
    of the default process group, one device each.

    ``devices`` names the ranks' device type ("cuda" or "cpu", or a
    ``torch.device``); None takes the port's ``device`` option (CUDA by
    default), and CUDA without a GPU raises.  The backend is NCCL on CUDA
    and gloo on the CPU; each CUDA rank takes the card of its local rank.
    With no process group yet, a launcher's environment (``torchrun``) is
    joined, and a plain process with no launcher forms a one-rank world, as
    the reference's mesh on one device is a one-device mesh.

    ``n_var > 1`` reserves a second axis for multivariate methods whose
    rotation matmuls contract over variables (MBCn/NpdfTransform) — those
    reduce over the var dimension's group; everything else is pure data
    parallelism.
    """
    kind = _device_type(devices)
    _join_world(kind)
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    world = dist.get_world_size()
    if n_var > 1:
        if world % n_var:
            raise ValueError(f"{world} devices not divisible by n_var={n_var}")
        return init_device_mesh(kind, (world // n_var, n_var), mesh_dim_names=(SITE_AXIS, VAR_AXIS))
    return init_device_mesh(kind, (world,), mesh_dim_names=(SITE_AXIS,))


def site_sharding(mesh: DeviceMesh, ndim: int, site_axis: int = 0):
    """The DTensor placements that partition axis ``site_axis`` of an
    ``ndim``-dimensional array over the site mesh dimension and replicate
    it over any other (time stays whole per shard)."""
    axis = range(ndim)[site_axis]
    return tuple(Shard(axis) if name == SITE_AXIS else Replicate() for name in mesh.mesh_dim_names)


def shard_sites(arr, mesh: DeviceMesh, site_axis: int = 0):
    """Place ``arr`` (numpy or a tensor, the same on every rank) on the mesh,
    partitioned along its site axis: each rank keeps its own block of its
    copy, with no communication.  The site count must be a multiple of the
    site dimension's size, as the reference's mesh requires."""
    x = as_tensor(arr, device=_mesh_device(mesh))
    placements = site_sharding(mesh, x.ndim, site_axis)
    _check_divisible(x.shape, mesh, placements)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _check_divisible(shape, mesh: DeviceMesh, placements) -> None:
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            size = mesh.size(mesh.mesh_dim_names.index(name))
            if shape[p.dim] % size:
                raise ValueError(
                    f"sharding over the mesh's {name!r} dimension implies that the global size of dimension {p.dim} "
                    f"should be divisible by {size}, but it is equal to {shape[p.dim]} (full shape: {tuple(shape)})"
                )


def _local(x, mesh: DeviceMesh, placements):
    """This rank's block of ``x`` laid out as ``placements``: a DTensor is
    redistributed, anything else (the same on every rank) sliced locally."""
    if isinstance(x, DTensor):
        _check_divisible(x.shape, mesh, placements)
        return x.redistribute(mesh, placements).to_local()
    x = as_tensor(x, device=_mesh_device(mesh))
    _check_divisible(x.shape, mesh, placements)
    return distribute_tensor(x, mesh, placements, src_data_rank=None).to_local()


def _matmul(a, b):
    """``a @ b`` in full float32 on the card (TF32 off), as the reference's
    products run at HIGHEST precision."""
    with full_float32_matmul():
        return torch.matmul(a, b)


def _all_reduce(x, op, group):
    dist.all_reduce(x, op=op, group=group)
    return x


def sharded_pairwise_corr(x, mesh: DeviceMesh):
    """All-site pairwise Pearson correlation over a site-sharded mesh.

    The one all-to-all pattern of this domain is the spatial diagnostics'
    pairwise matrices (reference ``utils.py:977-1025`` / ``nbutils.py:424-445``
    feeding ``spatial_correlogram`` / ``decorrelation_length``).  Each rank
    standardizes its own site block, all-gathers the standardized blocks
    over the site dimension's group and computes its ``[S_local, S_global]``
    block with one ``torch.matmul`` (TF32 off).

    x: [S, T] (site-sharded, or numpy / a tensor the same on every rank;
    NaNs excluded pairwise-complete is NOT applied — rows with NaN yield
    NaN, as the reference's dense path).  Returns the [S, S] correlation
    matrix, a DTensor sharded on the first axis.
    """
    placements = site_sharding(mesh, 2)
    xl = _local(x, mesh, placements)
    xl = xl - torch.mean(xl, dim=-1, keepdim=True)
    nrm = torch.sqrt(torch.sum(xl * xl, dim=-1, keepdim=True))
    xl = xl / torch.where(nrm == 0, 1, nrm)
    group = mesh.get_group(SITE_AXIS)
    blocks = [torch.empty_like(xl) for _ in range(dist.get_world_size(group))]
    dist.all_gather(blocks, xl.contiguous(), group=group)
    return DTensor.from_local(_matmul(xl, torch.cat(blocks).T), mesh, placements)


def sharded_first_eof(x, mesh: DeviceMesh):
    """Leading EOF of a site-sharded field ``x`` [S, T] (additive anomalies).

    Same semantics as :func:`~xsdba_tpu_torch.ops.pca.first_eof_pattern` on
    the time-side Gram: each rank zero-fills its local anomaly block (NaNs
    are missing; all-NaN sites come back NaN), the [T, T] Gram matrix
    accumulates with ONE ``all_reduce(SUM)`` over the site dimension (the
    contraction runs over the sharded dim, so the collective moves a [T, T]
    block instead of gathering [S, T] data), the small ``eigh`` replicates
    on every rank, and each rank maps the leading time vector back to its
    own site loadings.  One more ``all_reduce(SUM)`` normalizes; the global
    sign anchor (largest |loading|, lowest site index on exact ties) is an
    ``all_reduce`` MAX / MIN pair and a SUM of the winner's sign.

    Returns ``(eof [S] sharded like x, var_frac)``, ``var_frac`` a
    replicated 0-d DTensor.
    """
    placements = site_sharding(mesh, 2)
    xl = _local(x, mesh, placements)                            # [S_loc, T]
    group = mesh.get_group(SITE_AXIS)
    finite = torch.isfinite(xl)
    n = torch.sum(finite, dim=-1, keepdim=True)
    mean = torch.sum(torch.where(finite, xl, 0.0), dim=-1, keepdim=True) / torch.clamp(n, min=1)
    a = torch.where(finite, xl - mean, 0.0)
    site_ok = torch.any(finite, dim=-1)
    g = _all_reduce(_matmul(a.T, a), dist.ReduceOp.SUM, group)  # [T, T] replicated
    w, u = torch.linalg.eigh(g)
    vloc = _matmul(a, u[:, -1])                                 # [S_loc]
    ss = _all_reduce(torch.sum(vloc * vloc), dist.ReduceOp.SUM, group)
    vloc = vloc / torch.where(ss == 0, 1.0, torch.sqrt(ss))
    iloc = torch.argmax(torch.abs(vloc))
    mloc = torch.abs(vloc)[iloc]
    mglob = _all_reduce(mloc.clone(), dist.ReduceOp.MAX, group)
    gidx = (mesh.get_local_rank(SITE_AXIS) * vloc.shape[0] + iloc).to(torch.int64)
    cand = torch.where(mloc == mglob, gidx, torch.iinfo(torch.int64).max)
    winner = _all_reduce(cand, dist.ReduceOp.MIN, group)
    sgn = _all_reduce(torch.where(gidx == winner, torch.sign(vloc[iloc]), 0.0), dist.ReduceOp.SUM, group)
    v = vloc * torch.where(sgn == 0, 1.0, sgn)
    tot = torch.sum(torch.where(w > 0, w, 0.0))
    var_frac = w[-1] / torch.where(tot == 0, 1.0, tot)
    eof = torch.where(site_ok, v, torch.nan)
    return DTensor.from_local(eof, mesh, site_sharding(mesh, 1)), DTensor.from_local(var_frac, mesh, (Replicate(),) * mesh.ndim)


def sharded_rotation_apply(rot, x, mesh: DeviceMesh):
    """Apply a rotation matrix over a var-sharded multivariate axis.

    The MBCn/NpdfTransform rotation ``y = R @ x`` contracts over the
    multivariate axis — the one place this domain has genuine tensor
    parallelism.  ``x`` [B, V, L] is sharded on B over the site dimension
    and on V over the ``var`` dimension; each rank holds the matching column
    block of R, computes its partial [B_loc, V, L] product and an
    ``all_reduce(SUM)`` over the var dimension's group sums the partials;
    each rank keeps its own rows.

    Returns y [B, V, L] sharded like x (a DTensor).
    """
    V = x.shape[-2]
    nvar = mesh.size(mesh.mesh_dim_names.index(VAR_AXIS))
    if V % nvar:
        raise ValueError(f"V={V} not divisible by var axis size {nvar}")
    rot_place = tuple(Shard(1) if name == VAR_AXIS else Replicate() for name in mesh.mesh_dim_names)
    x_place = tuple(Shard(0) if name == SITE_AXIS else Shard(1) for name in mesh.mesh_dim_names)
    r_cols = _local(rot, mesh, rot_place)                       # [V, V/p]
    x_rows = _local(x, mesh, x_place)                           # [B_loc, V/p, L]
    full = _all_reduce(_matmul(r_cols, x_rows), dist.ReduceOp.SUM, mesh.get_group(VAR_AXIS))
    k = mesh.get_local_rank(VAR_AXIS)
    rows = V // nvar
    return DTensor.from_local(full[..., k * rows : (k + 1) * rows, :].contiguous(), mesh, x_place)
