"""A dry run of the parallel layer over spawned ranks.

:func:`dryrun_multichip` is the port's analogue of the reference's
multi-device dry run (``__graft_entry__.dryrun_multichip``): it starts
``n_devices`` processes joined in one process group (gloo on the CPU, NCCL
on CUDA, one rank a card) and runs on them, in order, the fused QDM step
split by site, the rotation over a site × var mesh, the pairwise
correlation, the leading EOF and the windowed dayofyear EQM on both
windowed-quantile engines, asserting as the reference does.  Bias
adjustment is data-parallel over sites with no collective, so the split
steps must equal one process's result on the same device under ``==``.
Given an output directory, rank 0 also writes every gathered result there
(``.npy`` files and ``errors.json``), for a caller to hold against another
implementation.

:func:`example_problem` is the headline data recipe, beside the dry run as
the reference's ``_example_problem`` is beside its own; the problems of the
dry run's parts are built from it and from the generators below.

:func:`spawn_ranks` is the launcher: a ``FileStore`` in a temporary
directory, a timeout on every collective, and a deadline on the whole run,
so that a rank that fails before a collective fails the run instead of
leaving the others waiting.
"""

from __future__ import annotations

import datetime
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import mesh as _mesh

__all__ = ["dryrun_multichip", "example_problem", "spawn_ranks"]

#: seconds a collective may wait for the other ranks before it raises
COLLECTIVE_TIMEOUT = 60

#: the dry run's problems, at least these many sites (a multiple of the rank
#: count): the reference's ``tests/test_parallel.py`` sizes
QDM_SITES, QDM_YEARS, QDM_NQ = 16, 2, 50
EQM_SITES, EQM_YEARS, EQM_NQ, EQM_WINDOW = 8, 2, 10, 31
CORR_SITES, EOF_SITES = 16, 64
ROT_V, ROT_L = 4, 64
DTYPES = {"f32": np.float32, "f64": np.float64}


def _rank_main(rank, n_ranks, store, kind, fn, args):
    torch.set_num_threads(1)
    if kind == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        _mesh._BACKENDS[kind], store=dist.FileStore(store, n_ranks), rank=rank, world_size=n_ranks,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT),
    )
    try:
        fn(rank, n_ranks, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n_ranks: int, *args, device=None, timeout: float = 300.0) -> None:
    """Run ``fn(rank, n_ranks, *args)`` in ``n_ranks`` spawned processes
    joined in the default process group, each with one CPU thread, on
    ``device``'s type (None: the port's ``device`` option, CUDA by default;
    NCCL on CUDA with rank r on card r, gloo on the CPU).  ``fn`` and
    ``args`` are pickled: a module-level function and plain values.  Raises
    what a rank raised (the others are stopped), and ``TimeoutError`` when
    the ranks have not all ended ``timeout`` seconds after the start."""
    kind = _mesh._device_type(device)
    if kind == "cuda" and n_ranks > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one rank a card: {n_ranks} ranks, {torch.cuda.device_count()} card(s)")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(_rank_main, args=(n_ranks, store, kind, fn, args), nprocs=n_ranks, join=False, start_method="spawn")
        end = time.monotonic() + timeout
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
            if time.monotonic() >= end:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{n_ranks} ranks did not end within {timeout} s")


def dryrun_multichip(n_devices: int, device=None, out=None) -> None:
    """Run the parallel layer's parts on ``n_devices`` spawned ranks of
    ``device``'s type (None: the port's ``device`` option, CUDA by default;
    CUDA needs a card a rank), asserting each part's result:

    0. :func:`~.mesh.shard_sites` gives each rank its block of sites of
       its own copy, and the blocks gathered give the array back;
    1. the fused QDM train+adjust step (``models/_algos.py:
       qdm_train_adjust_core``) split by site, in float32 and float64, each
       rank on its block, gathered: equal under ``==`` to one process;
    2. with ``n_devices`` even, the rotation over an (n / 2) × 2 site × var
       mesh (``sharded_rotation_apply``) against ``einsum`` at 1e-5
       (float32) and 1e-12 (float64) (the reference runs it from 4 devices;
       2 make the smallest such mesh);
    3. ``sharded_pairwise_corr`` against ``np.corrcoef`` at rtol 1e-10;
    4. ``sharded_first_eof`` on a field with an all-NaN site and a missing
       sample: the NaN site NaN, the rest finite and of unit norm,
       ``0 < var_frac <= 1``; from 2 ranks, a largest |loading| tied
       exactly between two ranks' sites goes positive on the lower site;
    5. the windowed dayofyear + 31 EQM split by site, in float32 and
       float64: equal under ``==`` to one process;
    5b. the same step on the merge and the selection engines: equal to
        1e-5;
    6. ``n_var``, a var count and a site count that do not divide the mesh
       raise ``ValueError`` (each where the world's size can show it).

    With ``out`` (a directory), rank 0 writes every gathered result there
    as ``<name>.npy`` and the errors' classes and messages as
    ``errors.json``.  The run has :func:`spawn_ranks`' deadline."""
    kind = _mesh._device_type(device)
    spawn_ranks(_dryrun_rank, n_devices, kind, out, device=kind)


def example_problem(n_sites, n_years, seed=0, start="2000-01-01", dtype=np.float32):
    """The headline data recipe (``__graft_entry__._example_problem``):
    numpy ref ~ N(10, 2), hist ~ N(12, 3), sim ~ N(13, 3), drawn in turn
    from one generator, over ``n_years`` noleap years of daily data.
    Returns (time, [ref, hist, sim])."""
    from ..utils.calendar import date_range

    t = date_range(start, periods=365 * n_years, freq="D", calendar="noleap")
    rng = np.random.default_rng(seed)
    data = [rng.normal(mu, sd, (n_sites, len(t))).astype(dtype) for mu, sd in ((10, 2), (12, 3), (13, 3))]
    return t, data


def windowed_problem(n_sites, dtype=np.float32):
    """``tests/test_parallel.py``'s windowed EQM inputs: the headline
    recipe from seed 7 and 1950 (float64 draws cast to ``dtype``)."""
    return example_problem(n_sites, EQM_YEARS, seed=7, start="1950-01-01", dtype=dtype)


def monthly_qdm_step(t, device, nq=QDM_NQ, dtype=np.float32):
    """The fused monthly QDM train+adjust step over time ``t`` (additive,
    ``nq`` quantiles, linear, constant extrapolation) as a function of the
    (ref, hist, sim) tensors on ``device``."""
    from ..models._algos import qdm_train_adjust_core
    from ..models._wrap import device_brackets
    from ..ops.correction import equally_spaced_nodes
    from ..utils.grouper import Grouper

    gi = Grouper("time.month").indexes(t)
    static = (*(torch.as_tensor(a, device=device) for a in (gi.gather_idx, gi.group_idx, gi.scatter_slot)),
              device_brackets(gi, "linear", device), torch.as_tensor(equally_spaced_nodes(nq).astype(dtype), device=device))
    return lambda ref, hist, sim: qdm_train_adjust_core(ref, hist, sim, *static, kind="+", interp="linear", extrapolation="constant")


def windowed_eqm_step(t, device, nq=EQM_NQ, dtype=np.float32):
    """The windowed dayofyear + 31 EQM train+adjust step over time ``t``
    (additive, ``nq`` quantiles, linear) as a function of the (ref, hist,
    sim) tensors on ``device``; it returns the adjusted sim."""
    from ..models._algos import eqm_train_adjust_windowed
    from ..models._wrap import device_brackets
    from ..ops.correction import equally_spaced_nodes
    from ..utils.grouper import Grouper

    gi = Grouper("time.dayofyear", window=EQM_WINDOW).indexes(t)
    q = torch.as_tensor(equally_spaced_nodes(nq).astype(dtype), device=device)
    br = device_brackets(gi, "linear", device)
    return lambda ref, hist, sim: eqm_train_adjust_windowed(ref, hist, sim, gi.merge_plan, q, br, kind="+")[0]


def corr_field(n_sites=CORR_SITES):
    """The correlation's input, [n_sites, 300] float64 N(0, 1) from seed 9."""
    return np.random.default_rng(9).normal(0, 1, (n_sites, 300))


def eof_field(n_sites=EOF_SITES):
    """An [n_sites, 40] float64 field from seed 13 with an all-NaN site (5)
    and a missing sample (site 17, step 3), as ``tests/test_parallel.py``."""
    x = np.random.default_rng(13).normal(10, 2, (n_sites, 40))
    x[5] = np.nan
    x[17, 3] = np.nan
    return x


def tie_field(n):
    """A field over ``4 n`` sites whose largest |loading| is tied exactly
    between the first site of rank 0 and the first site of rank 1, with
    opposite signs (site 4 is site 0 negated; the rest is small noise)."""
    S, T = 4 * n, 30
    x = np.random.default_rng(17).normal(0, 0.01, (S, T))
    x[0] = 5 * np.sin(np.arange(T))
    x[S // n] = -x[0]
    return x


def rotation_problem(n, dtype=np.float32):
    """A [4, 4] rotation and [n, 4, 64] values from seed 1."""
    rng = np.random.default_rng(1)
    return rng.normal(size=(ROT_V, ROT_V)).astype(dtype), rng.normal(size=(n, ROT_V, ROT_L)).astype(dtype)


def _sites(n, at_least):
    """The least multiple of the rank count ``n`` that is at least ``at_least``."""
    return n * -(-at_least // n)


def _same(got, want) -> bool:
    return got.shape == want.shape and bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


def _dryrun_rank(rank, n, kind, out):
    from torch.distributed.tensor import DTensor, Shard

    from ..utils.options import set_options

    mesh = _mesh.site_mesh(kind)
    dev = _mesh._mesh_device(mesh)
    saved = {}
    gather = lambda local: DTensor.from_local(local, mesh, _mesh.site_sharding(mesh, local.ndim)).full_tensor()  # noqa: E731
    blocks = lambda arrays: [_mesh.shard_sites(a, mesh).to_local() for a in arrays]  # noqa: E731
    whole = lambda arrays: [torch.as_tensor(a, device=dev) for a in arrays]  # noqa: E731

    # 0. the layout
    d = _mesh.shard_sites(np.arange(8.0 * n * 10).reshape(8 * n, 10), mesh)
    assert tuple(mesh.mesh_dim_names) == (_mesh.SITE_AXIS,) and mesh.size() == n
    assert tuple(d.placements) == _mesh.site_sharding(mesh, 2) == (Shard(0),) and d.to_local().shape == (8, 10)
    saved["layout"] = gather(d.to_local())
    assert _same(saved["layout"].cpu(), torch.arange(8.0 * n * 10, dtype=torch.float64).reshape(8 * n, 10))
    own = _mesh.shard_sites(np.full((n, 2), float(rank)), mesh).to_local()   # each rank's copy its own
    assert bool((own == rank).all()), "shard_sites moved data between ranks"

    # 1. the fused QDM step split by site: no collective until the gather
    for tag, dtype in DTYPES.items():
        t, data = example_problem(_sites(n, QDM_SITES), QDM_YEARS, dtype=dtype)
        step = monthly_qdm_step(t, dev, dtype=dtype)
        scen = gather(step(*blocks(data)))
        assert scen.shape == data[0].shape and not bool(torch.isnan(scen).all()), "dry run produced all-NaN output"
        assert _same(scen, step(*whole(data))), f"the split QDM step ({tag}) differs from one process"
        saved[f"qdm_{tag}"] = scen

    # 2. the rotation contracted over a var dimension
    if n % 2 == 0:
        mesh2 = _mesh.site_mesh(kind, n_var=2)
        assert tuple(mesh2.mesh_dim_names) == (_mesh.SITE_AXIS, _mesh.VAR_AXIS) and tuple(mesh2.shape) == (n // 2, 2)
        for tag, tol in (("f32", 1e-5), ("f64", 1e-12)):
            rot, x = rotation_problem(n, DTYPES[tag])
            y = _mesh.sharded_rotation_apply(rot, x, mesh2)
            assert tuple(y.placements) == (Shard(0), Shard(1))
            saved[f"rot_{tag}"] = y = y.full_tensor()
            np.testing.assert_allclose(y.cpu().numpy(), np.einsum("ij,bjl->bil", rot, x), rtol=tol, atol=tol)

    # 3. the all-gather pattern: pairwise correlation
    x = corr_field(_sites(n, CORR_SITES))
    saved["corr"] = _mesh.sharded_pairwise_corr(_mesh.shard_sites(x, mesh), mesh).full_tensor()
    np.testing.assert_allclose(saved["corr"].cpu().numpy(), np.corrcoef(x), rtol=1e-10, atol=1e-12)

    # 4. the reduced-Gram pattern: the leading EOF, and its sign anchor
    eof, frac = _mesh.sharded_first_eof(_mesh.shard_sites(eof_field(_sites(n, EOF_SITES)), mesh), mesh)
    saved["eof"], saved["eof_frac"] = eof, frac = eof.full_tensor(), frac.to_local()
    ok = torch.arange(eof.shape[0], device=eof.device) != 5
    assert bool(torch.isnan(eof[5])) and bool(torch.isfinite(eof[ok]).all()) and 0.0 < float(frac) <= 1.0
    nrm = float(torch.linalg.vector_norm(eof[ok]))
    assert abs(nrm - 1.0) < 1e-12, f"EOF not unit-norm: {nrm}"
    if n >= 2:
        v, frac = _mesh.sharded_first_eof(tie_field(n), mesh)
        saved["tie"], saved["tie_frac"] = v, _ = v.full_tensor(), frac.to_local()
        assert float(v[0]) == -float(v[4]) and float(v[0]) > 0 and float(v.abs().max()) == float(v[0]), "the tie went to a higher site"

    # 5. the windowed dayofyear + 31 EQM split by site, on the default
    # engine and (5b) on each engine
    for tag, dtype in DTYPES.items():
        t, data = windowed_problem(_sites(n, EQM_SITES), dtype)
        step = windowed_eqm_step(t, dev, dtype=dtype)
        hblocks = blocks(data)
        scen = gather(step(*hblocks))
        assert scen.shape == data[0].shape and not bool(torch.isnan(scen).all())
        assert _same(scen, step(*whole(data))), f"the split windowed EQM ({tag}) differs from one process"
        saved[f"eqm_{tag}"] = scen
        with set_options(selection_backend=False):
            merged = gather(step(*hblocks))
        with set_options(selection_on_tpu=True):
            selected = gather(step(*hblocks))
        np.testing.assert_allclose(merged.cpu().numpy(), selected.cpu().numpy(), rtol=1e-5, atol=1e-5)

    # 6. the errors, raised on every rank before any collective
    errors = {}
    cases = [("n_var", lambda: _mesh.site_mesh(kind, n_var=n + 1))]
    if n % 2 == 0:
        cases.append(("V", lambda: _mesh.sharded_rotation_apply(np.eye(3, dtype=np.float32), np.zeros((n, 3, 4), np.float32), mesh2)))
    if n >= 2:
        cases.append(("sites", lambda: _mesh.shard_sites(np.zeros((n + 1, 4)), mesh)))
    for case, call in cases:
        try:
            call()
        except ValueError as e:
            errors[case] = [type(e).__name__, str(e)]
        else:
            raise AssertionError(f"{case}: no ValueError")

    if out is not None and rank == 0:
        for name, value in saved.items():
            np.save(os.path.join(out, f"{name}.npy"), value.cpu().numpy())
        with open(os.path.join(out, "errors.json"), "w") as f:
            json.dump(errors, f)
