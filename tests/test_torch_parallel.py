"""The port's parallel layer (``xsdba_tpu_torch/parallel``) on gloo ranks,
against the one-process port and the JAX package's layer.

The JAX package tests its layer on 8 virtual CPU devices
(``tests/test_parallel.py``); here each world size (2, 4 and 8 ranks) is one
run of the port's dry run (``parallel/dryrun.py:dryrun_multichip``, which
imports no JAX) on spawned processes joined in a gloo process group on a
``FileStore``: its ranks assert every part, and rank 0 writes the gathered
results to ``tmp_path``.  The test process computes the JAX package's
results (its sharded collectives on its 8 virtual devices, once) and the
one-process port's on the CPU.  Tolerances: the split adjust steps equal
the one-process port under ``==`` and the reference at
``tests/test_parallel.py``'s rtol 1e-12; the pairwise correlation at rtol
1e-10 / atol 1e-12; the leading EOF at atol 1e-10 and ``var_frac`` at rel
1e-10; the rotation at 1e-5 (float32) and 1e-12 (float64) of ``einsum``.
Every spawn has its own deadline (``spawn_ranks``), and every collective a
60 s timeout, so a broken rank fails its test instead of hanging the run.
"""

import json
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xsdba_tpu_torch as xp
from xsdba_tpu.parallel import mesh as jmesh
from xsdba_tpu_torch.parallel import dryrun as D
from xsdba_tpu_torch.parallel import mesh as tmesh

#: what the dry run writes on every world size of these tests
RESULTS = {"layout", "qdm_f32", "qdm_f64", "rot_f32", "rot_f64", "corr", "eof", "eof_frac", "tie", "tie_frac", "eqm_f32", "eqm_f64"}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


@pytest.fixture(scope="module", params=[2, 4, 8], ids=lambda n: f"{n} ranks")
def ranks(request, tmp_path_factory):
    """(n, the results of the dry run on n gloo ranks)."""
    n = request.param
    if len(jax.devices()) < n:
        pytest.skip(f"the reference needs {n} virtual devices")
    out = tmp_path_factory.mktemp(f"ranks{n}")
    D.dryrun_multichip(n, device="cpu", out=str(out))
    got = {f.stem: np.load(f) for f in out.glob("*.npy")}
    got["errors"] = json.loads((out / "errors.json").read_text())
    return n, got


def _jmesh(n, n_var=1):
    return jmesh.site_mesh(jax.devices()[:n], n_var=n_var)


@lru_cache(maxsize=None)
def _reference_sharded(name):
    """The reference's sharded correlation or EOF on its 8-device mesh
    (``tests/test_parallel.py``'s), once: the result does not depend on the
    device count, and each call compiles its ``shard_map`` anew."""
    x = jnp.asarray(D.corr_field() if name == "corr" else D.eof_field())
    mesh = _jmesh(8)
    out = (jmesh.sharded_pairwise_corr if name == "corr" else jmesh.sharded_first_eof)(jmesh.shard_sites(x, mesh), mesh)
    return np.asarray(out) if name == "corr" else tuple(np.asarray(a) for a in out)


@lru_cache(maxsize=None)
def _qdm_reference(tag):
    from __graft_entry__ import _example_problem
    from xsdba_tpu.models._algos import qdm_train_adjust_core

    args = _example_problem(n_sites=D.QDM_SITES, n_years=D.QDM_YEARS, dtype=D.DTYPES[tag])
    fn = partial(qdm_train_adjust_core.__wrapped__, kind="+", interp="linear", extrapolation="constant")
    return [np.asarray(a) for a in args[:3]], np.asarray(args[7]), np.asarray(jax.jit(fn)(*args))


@lru_cache(maxsize=None)
def _eqm_reference(tag):
    from xsdba_tpu.models._algos import eqm_train_adjust_windowed
    from xsdba_tpu.models._wrap import device_brackets
    from xsdba_tpu.utils.calendar import date_range
    from xsdba_tpu.utils.grouper import Grouper
    from xsdba_tpu_torch.ops.correction import equally_spaced_nodes

    t = date_range("1950-01-01", periods=365 * D.EQM_YEARS, freq="D", calendar="noleap")
    gi = Grouper("time.dayofyear", window=D.EQM_WINDOW).indexes(t)
    _, data = D.windowed_problem(D.EQM_SITES, D.DTYPES[tag])
    q = equally_spaced_nodes(D.EQM_NQ).astype(D.DTYPES[tag])
    want, _, _ = eqm_train_adjust_windowed(*map(jnp.asarray, data), gi.merge_plan, jnp.asarray(q), device_brackets(gi, "linear"), kind="+")
    return np.asarray(want)


@lru_cache(maxsize=None)
def _one_process(step, tag):
    """The port's ``monthly_qdm_step`` or ``windowed_eqm_step`` on the whole problem, in one process on the CPU."""
    t, data = D.example_problem(D.QDM_SITES, D.QDM_YEARS, dtype=D.DTYPES[tag]) if step == "qdm" else D.windowed_problem(D.EQM_SITES, D.DTYPES[tag])
    run = (D.monthly_qdm_step if step == "qdm" else D.windowed_eqm_step)(t, "cpu", dtype=D.DTYPES[tag])
    return run(*map(torch.as_tensor, data)).numpy()


@pytest.mark.parametrize("tag", ["f64", "f32"])
def test_sharded_qdm_step_equals_one_process_and_reference(ranks, tag):
    """The fused QDM step on each rank's sites, gathered: the one-process
    port under ``==``, the reference at rtol 1e-12 (on the reference's own
    inputs: the helper's recipe is checked against them)."""
    from xsdba_tpu_torch.ops.correction import equally_spaced_nodes

    _, got = ranks
    _, data = D.example_problem(D.QDM_SITES, D.QDM_YEARS, dtype=D.DTYPES[tag])
    jdata, jq, want = _qdm_reference(tag)
    for a, b in zip(data + [equally_spaced_nodes(D.QDM_NQ).astype(D.DTYPES[tag])], jdata + [jq]):
        np.testing.assert_array_equal(a, b)
    scen = got[f"qdm_{tag}"]
    assert scen.dtype == D.DTYPES[tag] and scen.shape == (D.QDM_SITES, 365 * D.QDM_YEARS)
    np.testing.assert_array_equal(scen, _one_process("qdm", tag))
    np.testing.assert_allclose(scen, want, rtol=1e-12)


@pytest.mark.parametrize("tag", ["f64", "f32"])
def test_sharded_windowed_eqm_equals_one_process_and_reference(ranks, tag):
    """The windowed dayofyear + 31 EQM on each rank's sites: the one-process
    port under ``==``, the reference at rtol 1e-12."""
    _, got = ranks
    scen = got[f"eqm_{tag}"]
    np.testing.assert_array_equal(scen, _one_process("eqm", tag))
    np.testing.assert_allclose(scen, _eqm_reference(tag), rtol=1e-12)


def test_sharded_pairwise_corr(ranks):
    """``np.corrcoef`` and the reference's sharded correlation (its 8-device
    mesh), at rtol 1e-10 / atol 1e-12."""
    _, got = ranks
    x = D.corr_field()
    np.testing.assert_allclose(got["corr"], np.corrcoef(x), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["corr"], _reference_sharded("corr"), rtol=1e-10, atol=1e-12)


def test_sharded_first_eof(ranks):
    """An all-NaN site and a missing sample: the reference's sharded EOF (its
    8-device mesh) and its serial ``first_eof_pattern`` at atol 1e-10,
    ``var_frac`` at rel 1e-10; the NaN site NaN, the EOF of unit norm."""
    from xsdba_tpu.ops.pca import first_eof_pattern

    _, got = ranks
    x = D.eof_field()
    v, frac = _reference_sharded("eof")
    finite = np.isfinite(x)
    mean = np.where(finite, x, 0.0).sum(axis=1, keepdims=True) / np.maximum(finite.sum(axis=1, keepdims=True), 1)
    want_v, want_frac = first_eof_pattern(jnp.asarray(np.where(finite, x - mean, np.nan).T))
    for wv, wf in ((v, frac), (want_v, want_frac)):
        np.testing.assert_allclose(got["eof"], np.asarray(wv), rtol=0, atol=1e-10)
        assert float(got["eof_frac"]) == pytest.approx(float(wf), rel=1e-10)
    assert np.isnan(got["eof"][5]) and np.isnan(got["eof"]).sum() == 1
    assert np.linalg.norm(np.nan_to_num(got["eof"])) == pytest.approx(1.0, rel=1e-12)


def test_sign_anchor_tie_picks_the_lowest_site(ranks):
    """The largest |loading| tied exactly between rank 0's first site and
    rank 1's (opposite signs): the lower global site is made positive, as
    the reference's MIN of the candidates does; the loadings' magnitudes
    and ``var_frac`` are the reference's serial ``first_eof_pattern``'s."""
    from xsdba_tpu.ops.pca import first_eof_pattern

    n, got = ranks
    v = got["tie"]
    S = v.shape[0]
    assert v[0] == -v[S // n] and v[0] > 0 and np.abs(v).max() == v[0]
    x = D.tie_field(n)
    want_v, want_frac = first_eof_pattern(jnp.asarray((x - x.mean(axis=1, keepdims=True)).T))
    np.testing.assert_allclose(np.abs(v), np.abs(np.asarray(want_v)), rtol=0, atol=1e-10)
    assert float(got["tie_frac"]) == pytest.approx(float(want_frac), rel=1e-10)


@pytest.mark.parametrize("tag,tol", [("f32", 1e-5), ("f64", 1e-12)])
def test_sharded_rotation_apply(ranks, tag, tol):
    """On an (n / 2) × 2 site × var mesh: ``einsum`` of the rotation."""
    n, got = ranks
    rot, x = D.rotation_problem(n, D.DTYPES[tag])
    y = got[f"rot_{tag}"]
    assert y.dtype == D.DTYPES[tag]
    np.testing.assert_allclose(y, np.einsum("ij,bjl->bil", rot, x), rtol=tol, atol=tol)


def test_errors_are_the_reference_s(ranks):
    """``n_var`` not dividing the world and ``V`` not dividing the var size:
    the reference's ``ValueError`` and message; sites not dividing the site
    size: a ``ValueError``, as the reference's ``device_put`` raises."""
    n, got = ranks
    errors = got["errors"]
    with pytest.raises(ValueError) as jn:
        _jmesh(n, n_var=n + 1)
    assert errors["n_var"] == ["ValueError", str(jn.value)]
    with pytest.raises(ValueError) as jv:
        jmesh.sharded_rotation_apply(jnp.eye(3), jnp.zeros((n, 3, 4)), _jmesh(n, n_var=2))
    assert errors["V"] == ["ValueError", str(jv.value)]
    with pytest.raises(ValueError, match="divisible"):
        jmesh.shard_sites(jnp.zeros((n + 1, 4)), _jmesh(n))
    assert errors["sites"][0] == "ValueError" and "divisible" in errors["sites"][1]


def test_shard_sites_layout(ranks):
    """Gathering each rank's block gives the array back (each rank's block
    and placements are asserted on the ranks)."""
    n, got = ranks
    np.testing.assert_array_equal(got["layout"], np.arange(8.0 * n * 10).reshape(8 * n, 10))


def test_dryrun_multichip_runs_every_part(ranks):
    """The dry run on n gloo ranks asserted every part on its ranks (the
    fixture's run raised otherwise) and wrote every part's result."""
    _, got = ranks
    assert set(got) == RESULTS | {"errors"} and set(got["errors"]) == {"n_var", "V", "sites"}


def test_one_rank_world_without_a_launcher():
    """A plain process with no launcher and no process group forms a
    one-rank world, as the reference's mesh on one device: the mesh, the
    layout and each collective on it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    assert not dist.is_initialized()
    try:
        mesh = tmesh.site_mesh("cpu")
        assert dist.get_world_size() == 1 and tuple(mesh.shape) == (1,) and mesh.device_type == "cpu"
        x = D.corr_field()
        np.testing.assert_allclose(tmesh.sharded_pairwise_corr(x, mesh).full_tensor().numpy(), np.corrcoef(x), rtol=1e-10, atol=1e-12)
        v, _ = tmesh.sharded_first_eof(D.eof_field(), mesh)
        assert np.isnan(v.full_tensor().numpy()[5])
        rot, xr = D.rotation_problem(2, np.float64)
        mesh2 = init_device_mesh("cpu", (1, 1), mesh_dim_names=(tmesh.SITE_AXIS, tmesh.VAR_AXIS))
        y = tmesh.sharded_rotation_apply(rot, xr, mesh2)
        np.testing.assert_allclose(y.full_tensor().numpy(), np.einsum("ij,bjl->bil", rot, xr), rtol=1e-12)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_site_mesh_on_cuda_without_a_card_raises():
    """The ``device`` option's CUDA (the default) without a GPU raises the
    port's ``RuntimeError`` naming the CPU option, from the mesh and from
    the launchers, before any rank starts; no quiet CPU world."""
    import torch.distributed as dist

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with xp.set_options(device="cuda"):
        for call in (tmesh.site_mesh, lambda: D.spawn_ranks(print, 1), lambda: D.dryrun_multichip(1)):
            with pytest.raises(RuntimeError, match="set_options"):
                call()
    with pytest.raises(RuntimeError, match="set_options"):
        tmesh.site_mesh("cuda")
    assert not dist.is_initialized()
