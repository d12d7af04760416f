"""Public ``MBCn`` and ``NpdfTransform`` of the port against the JAX package,
on the CPU.

The same numpy inputs go through both packages; the rotations are always
injected (``rot_matrices=``), drawn once by the reference, because a
``torch.Generator`` cannot reproduce its Threefry stream.

Tolerances (``tests/test_torch_npdft.py`` explains their source: a V x V
rotation whose summation order XLA chooses, and sums of moments).  float64:
``af_q``, ``scen`` and the transformed series at 1e-10, energy scores at
1e-6 relative.  float32: ``af_q`` at 5e-5 absolute, scores at 2e-3
relative; over 20 float32 iterations the two packages' states can part
(``_assert_parting_trajectories``).  MBCn's float32 ``scen`` is a
*reordering* of the per-variable QDM output by the npdft ranks: its sorted
values equal the reference's exactly (the univariate step rounds as the
reference does), and where an ulp of the rotated state swaps two
neighbouring ranks a position takes its rank neighbour's value, so at most
1 % of the positions may differ and each by no more than 3 places in the
sorted series.
"""

import os

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from e2e_cases import JAX_SEED, build_inputs
from xsdba_tpu.ops.rotation import rand_rot_matrix
from xsdba_tpu.utils.rng import seed as jax_seed
from xsdba_tpu_torch.models import mbcn as tmbcn


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


FROZEN = os.path.join(os.path.dirname(__file__), "golden", "e2e_scen.npz")
S, V, T = 2, 3, 365 * 3
MV = np.array(["pr", "tas", "wind"])
F64 = dict(rtol=0, atol=1e-10, equal_nan=True)
AF_Q32 = dict(rtol=0, atol=5e-5, equal_nan=True)
ESCORE = {np.float64: dict(rtol=1e-6, atol=1e-9), np.float32: dict(rtol=2e-3, atol=1e-5)}


def _mv(mod, seed, dtype=np.float64, start="1981-01-01", dims=("site", "multivar", "time"), nan=False):
    """[site, multivar, time] correlated normals as ``mod``'s DataArray."""
    rng = np.random.default_rng(seed)
    x = rng.normal(10, 3, (S, V, T))
    x[:, 1] += 0.5 * x[:, 0]
    if nan:
        x[0, 1, 50:55] = np.nan
    t = mod.date_range(start, periods=T, freq="D", calendar="noleap")
    da = mod.DataArray(x.astype(dtype), ("site", "multivar", "time"), {"time": t, "multivar": MV, "site": np.arange(S)}, {"units": ""}, "data")
    return da.transpose(*dims) if dims != da.dims else da


@pytest.fixture(scope="module")
def rots():
    jax_seed(11)
    return np.array(rand_rot_matrix(V, num=20, dtype=np.float64))


def _np(da):
    return da.data.numpy() if isinstance(da.data, torch.Tensor) else np.asarray(da.data)


def _grouper(mod, group):
    return mod.Grouper(*group) if isinstance(group, tuple) else group


def _train_adjust(mod, dtype, group, n_iter, rots, n_escore=50, nan=False, **adjust_kw):
    kw = dict(base_kws={"nquantiles": 8, "group": _grouper(mod, group)}, n_iter=n_iter, n_escore=n_escore, rot_matrices=rots[:n_iter].astype(dtype))
    obj = mod.MBCn.train(_mv(mod, 1, dtype, nan=nan), _mv(mod, 2, dtype), **kw)
    scen = obj.adjust(_mv(mod, 3, dtype, "2041-01-01"), _mv(mod, 1, dtype, nan=nan), _mv(mod, 2, dtype), **adjust_kw)
    return obj, scen


def _assert_reordering_close(got, want, share=0.01, places=3):
    """Series [..., time] that hold the same values: at most ``share`` of the
    positions differ, each by at most ``places`` places in the sorted series."""
    np.testing.assert_array_equal(np.sort(got, axis=-1), np.sort(want, axis=-1))
    differ = got != want
    assert differ.mean() <= share, differ.mean()
    for g, w in zip(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])):
        ordered = np.sort(w)
        moved = np.abs(np.searchsorted(ordered, g) - np.searchsorted(ordered, w))
        assert moved.max(initial=0) <= places, moved.max()


def _assert_parting_trajectories(af_q, af_q_w, first=3):
    """float32 ``af_q`` [site, group, iteration, V, nq] over many iterations.
    An ulp of a rotated state swaps two near-equal order statistics now and
    then (about once in five rows of 1095 values an iteration); the two then
    take each other's factor, and when a node boundary of the ``nearest``
    lookup lies between them the two packages' states part by a node step
    and stay apart (observed: one of two sites from iteration 8 on, up to
    2e-2 on factors of 5e-2).  So: every site agrees at 5e-5 over the
    ``first`` iterations, a site that has parted stays within the factors'
    own size, and not every site parts.  Returns the mask of the sites that
    stayed together throughout."""
    d = np.abs(af_q - af_q_w).max(axis=(1, 3, 4))                # [site, iteration]
    assert (d[:, :first] <= 5e-5).all(), d[:, :first]
    assert d.max() <= np.abs(af_q_w).max(), d.max()
    together = (d <= 5e-5).all(axis=1)
    assert together.any(), d
    return together


MBCN_CASES = [
    (np.float64, "time", 3),
    (np.float64, "time", 20),
    (np.float64, ("time.dayofyear", 5), 3),
    (np.float32, "time", 3),
    (np.float32, "time", 20),
    (np.float32, ("time.dayofyear", 5), 3),
]


@pytest.mark.parametrize("dtype,group,n_iter", MBCN_CASES, ids=lambda v: getattr(v, "__name__", None) or (str(v) if not isinstance(v, tuple) else "doy5"))
def test_mbcn_matches_reference(rots, dtype, group, n_iter):
    want, scen_w = _train_adjust(xt, dtype, group, n_iter, rots)
    got, scen = _train_adjust(xp, dtype, group, n_iter, rots)
    for name in ("af_q", "escores", "rot_matrices"):
        assert got.ds[name].dims == want.ds[name].dims, name
        assert _np(got.ds[name]).shape == np.asarray(want.ds[name].data).shape
    assert got.ds["af_q"].dims[0] == "site" and _np(got.ds["af_q"]).dtype == dtype
    assert got.pts_dims == want.pts_dims and got.interp == "nearest" and got.extrapolation == "constant" and got.n_escore == 50
    assert scen.dims == scen_w.dims == ("site", "multivar", "time") and _np(scen).dtype == dtype
    assert scen.attrs["bias_adjustment"].startswith("MBCn(")
    af_q, af_q_w = _np(got.ds["af_q"]), np.asarray(want.ds["af_q"].data)
    if dtype is np.float32 and n_iter == 20:
        # 20 float32 iterations: see _assert_parting_trajectories
        together = _assert_parting_trajectories(af_q, af_q_w)
        np.testing.assert_array_equal(np.sort(_np(scen), axis=-1), np.sort(np.asarray(scen_w.data), axis=-1))
        _assert_reordering_close(_np(scen)[together], np.asarray(scen_w.data)[together])
        return
    np.testing.assert_allclose(af_q, af_q_w, **(F64 if dtype is np.float64 else AF_Q32))
    np.testing.assert_allclose(_np(got.ds["escores"]), np.asarray(want.ds["escores"].data), **ESCORE[dtype])
    if dtype is np.float64:
        np.testing.assert_allclose(_np(scen), np.asarray(scen_w.data), **F64)
    elif group == "time":
        _assert_reordering_close(_np(scen), np.asarray(scen_w.data))
    else:
        # window centres of reordered blocks: no common multiset to sort
        off = np.abs(_np(scen) - np.asarray(scen_w.data)) > 1e-4
        assert off.mean() <= 0.01, off.mean()


def test_mbcn_scen_is_a_permutation_of_the_univariate_qdm():
    """With one group each variable's ``scen`` holds exactly the values of
    its univariate QDM adjustment, reordered."""
    obj = xp.MBCn.train(_mv(xp, 1), _mv(xp, 2), base_kws={"nquantiles": 8}, n_iter=3)
    sim = _mv(xp, 3, start="2041-01-01")
    scen = _np(obj.adjust(sim, _mv(xp, 1), _mv(xp, 2)))
    one = lambda da, iv: xp.DataArray(da.data[:, iv], ("site", "time"), {"time": da.coords["time"]}, {"units": ""}, "v")  # noqa: E731
    for iv in range(V):
        qdm = xp.QuantileDeltaMapping.train(one(_mv(xp, 1), iv), one(_mv(xp, 2), iv), nquantiles=8, group="time", kind="+")
        uni = _np(qdm.adjust(one(sim, iv), interp="nearest"))
        np.testing.assert_array_equal(np.sort(scen[:, iv], axis=-1), np.sort(uni, axis=-1))
        assert (scen[:, iv] != uni).any()


def test_mbcn_draws_its_rotations_from_the_stream():
    from xsdba_tpu_torch.utils import rng as trng

    trng.seed(4)
    a = xp.MBCn.train(_mv(xp, 1), _mv(xp, 2), base_kws={"nquantiles": 6}, n_iter=1)
    rot = _np(a.ds["rot_matrices"])
    assert rot.shape == (1, V, V) and rot.dtype == np.float64
    np.testing.assert_allclose(rot[0] @ rot[0].T, np.eye(V), atol=1e-12)
    trng.seed(4)
    b = xp.MBCn.train(_mv(xp, 1), _mv(xp, 2), base_kws={"nquantiles": 6}, n_iter=1)
    np.testing.assert_array_equal(_np(b.ds["af_q"]), _np(a.ds["af_q"]))
    c = xp.MBCn.train(_mv(xp, 1), _mv(xp, 2), base_kws={"nquantiles": 6}, n_iter=1, rot_matrices=rot)
    np.testing.assert_array_equal(_np(c.ds["af_q"]), _np(a.ds["af_q"]))


def test_mbcn_chunked_equals_unchunked(monkeypatch, rots):
    """Group-chunked training and adjusting (a shorter last chunk) give the
    unchunked result bit for bit: every block is its own batch row."""
    group = ("time.dayofyear", 5)
    full, scen_full = _train_adjust(xp, np.float64, group, 3, rots, nan=True)
    batch = S * V
    monkeypatch.setattr(tmbcn, "_TRAIN_CHUNK_BUDGET", batch * 5 * 3 * 100)     # 100 of 365 blocks a chunk: 4 chunks, the last of 65
    assert tmbcn._chunk_size(365, batch, 15) == 100
    chunked, scen_chunked = _train_adjust(xp, np.float64, group, 3, rots, nan=True)
    for name in ("af_q", "escores"):
        assert _np(chunked.ds[name]).shape == _np(full.ds[name]).shape
        np.testing.assert_array_equal(_np(chunked.ds[name]), _np(full.ds[name]))
    np.testing.assert_array_equal(_np(scen_chunked), _np(scen_full))
    assert np.isfinite(_np(scen_full)).all()


def test_mbcn_site_batch_and_dim_order(rots):
    """Any dim order, extra batch dims: a site-batched run equals per-site
    runs with the same rotations, and sim's dim order comes back."""
    kw = dict(base_kws={"nquantiles": 8, "group": "time"}, n_iter=2, n_escore=-1, rot_matrices=rots[:2])
    dims = ("time", "site", "multivar")
    obj = xp.MBCn.train(_mv(xp, 1, dims=dims), _mv(xp, 2), **kw)
    assert obj.ds["af_q"].dims == ("site", "group", "iterations", "multivar_prime", "quantiles")
    sim = _mv(xp, 3, start="2041-01-01", dims=dims)
    scen = obj.adjust(sim, _mv(xp, 1), _mv(xp, 2, dims=("multivar", "time", "site")))
    assert scen.dims == dims
    one = lambda da: xp.DataArray(da.data[1], ("multivar", "time"), {"time": da.coords["time"], "multivar": MV}, {"units": ""}, "d")  # noqa: E731
    obj1 = xp.MBCn.train(one(_mv(xp, 1)), one(_mv(xp, 2)), **kw)
    scen1 = obj1.adjust(one(_mv(xp, 3, start="2041-01-01")), one(_mv(xp, 1)), one(_mv(xp, 2)))
    np.testing.assert_allclose(np.moveaxis(_np(scen), 0, -1)[1], _np(scen1), rtol=1e-12, atol=1e-12)


def test_mbcn_period_dim(rots):
    """A hand-stacked sim [multivar, period, time] flows through as a batch
    dim; each period equals its own adjustment, and the reference's."""
    kw = dict(base_kws={"nquantiles": 8, "group": "time"}, n_iter=2, n_escore=-1, rot_matrices=rots[:2])

    def stacked(mod):
        a, b = (_mv(mod, s, start="2041-01-01").data[0] for s in (3, 4))          # [V, T] each
        stack = np.stack if isinstance(a, np.ndarray) else torch.stack
        t = mod.date_range("2041-01-01", periods=T, freq="D", calendar="noleap")
        return mod.DataArray(stack([a, b], 1), ("multivar", "period", "time"), {"time": t, "multivar": MV, "period": np.arange(2)}, {"units": ""}, "sim")

    one = lambda mod, s, start="1981-01-01": mod.DataArray(  # noqa: E731
        _mv(mod, s, start=start).data[0], ("multivar", "time"), {"time": mod.date_range(start, periods=T, freq="D", calendar="noleap"), "multivar": MV}, {"units": ""}, "d"
    )
    want = xt.MBCn.train(one(xt, 1), one(xt, 2), **kw).adjust(stacked(xt), one(xt, 1), one(xt, 2), period_dim="period")
    obj = xp.MBCn.train(one(xp, 1), one(xp, 2), **kw)
    got = obj.adjust(stacked(xp), one(xp, 1), one(xp, 2), period_dim="period")
    assert got.dims == want.dims == ("multivar", "period", "time")
    np.testing.assert_allclose(_np(got), np.asarray(want.data), **F64)
    alone = obj.adjust(one(xp, 4, "2041-01-01"), one(xp, 1), one(xp, 2))
    np.testing.assert_allclose(_np(got)[:, 1], _np(alone), rtol=1e-12, atol=1e-12)


def test_mbcn_refusals(rots):
    ref, hist, sim = _mv(xp, 1), _mv(xp, 2), _mv(xp, 3, start="2041-01-01")
    with pytest.raises(NotImplementedError, match="Monthly"):
        xp.MBCn.train(ref, hist, base_kws={"group": "time.month"})
    with pytest.raises(NotImplementedError, match="add_dims"):
        xp.MBCn.train(ref, hist, base_kws={"group": xp.Grouper("time.dayofyear", window=5, add_dims=["site"])})
    obj = xp.MBCn.train(ref, hist, base_kws={"nquantiles": 6}, n_iter=1, rot_matrices=rots[:1])
    with pytest.raises(NotImplementedError, match="Unsupported base_kws_vars"):
        obj.adjust(sim, ref, hist, base_kws_vars={"pr": {"max_tail_factor": 2}})
    with pytest.raises(ValueError, match="must be the same"):
        obj.adjust(sim, ref, hist, base_kws_vars={"pr": {"group": "time.dayofyear"}})
    with pytest.raises(ValueError, match="same time length"):
        obj.adjust(sim.isel(time=np.arange(T - 365)), ref, hist)
    # a multiplicative variable is accepted, as in the reference
    scen = obj.adjust(sim, ref, hist, base_kws_vars={"pr": {"kind": "*"}})
    assert np.isfinite(_np(scen)).all()


def _pr_tas(mod, seed, start="1981-01-01"):
    """A Dataset of daily pr (mm/d, a third of the days dry) and tas (K) at
    S sites, stacked as the multivariate workflow stacks it.  The dry days
    hold distinct traces under 0.005 mm/d: exact ties at zero would put
    pct ranks on the midpoints of the ``nearest`` nodes, where an ulp of the
    rotated state decides (ROADMAP C12, in float64 here)."""
    rng = np.random.default_rng(seed)
    t = mod.date_range(start, periods=T, freq="D", calendar="noleap")
    pr = np.where(rng.random((S, T)) < 0.67, rng.gamma(0.8, 4, (S, T)), rng.uniform(0, 0.005, (S, T)))
    tas = 280 + rng.normal(0, 3, (S, T)) + 0.2 * pr
    mk = lambda x, u, nm: mod.DataArray(x, ("site", "time"), {"time": t}, {"units": u}, nm)  # noqa: E731
    return mod.processing.stack_variables(mod.Dataset({"pr": mk(pr, "mm/d", "pr"), "tas": mk(tas, "K", "tas")}))


@pytest.mark.parametrize("pr_kws", [
    {"kind": "*", "adapt_freq_thresh": "1 mm/d", "jitter_under_thresh_value": "0.01 mm/d"},
    {"jitter_under_thresh_value": "0.01 mm/d"},
    {"kind": "*", "adapt_freq_thresh": "1 mm/d"},
], ids=["both", "jitter", "adapt_freq"])
def test_mbcn_base_kws_vars_preprocessing_matches_reference(monkeypatch, pr_kws):
    """``base_kws_vars``' dry-day preprocessing of one variable: its ref,
    hist and sim jittered under the threshold and hist's and sim's blocks
    frequency-adapted before the block's QDM, the port drawing the JAX
    package's draws (``tests/test_torch_qdm.py:reference_draws``): ``scen``
    at 1e-10 (float64, the tolerance of every MBCn case here)."""
    from test_torch_qdm import reference_draws

    reference_draws(monkeypatch)
    jax_seed(11)
    rot = np.array(rand_rot_matrix(2, num=2, dtype=np.float64))
    out = {}
    for mod in (xt, xp):
        ref, hist, sim = _pr_tas(mod, 1), _pr_tas(mod, 2), _pr_tas(mod, 3, "2041-01-01")
        obj = mod.MBCn.train(ref, hist, base_kws={"nquantiles": 8}, n_iter=2, n_escore=-1, rot_matrices=rot)
        jax_seed(JAX_SEED)
        out[mod] = _np(obj.adjust(sim, ref, hist, base_kws_vars={"pr": dict(pr_kws)}))
    assert np.isfinite(out[xp]).all()
    np.testing.assert_allclose(out[xp], out[xt], **F64)
    plain = xp.MBCn.train(_pr_tas(xp, 1), _pr_tas(xp, 2), base_kws={"nquantiles": 8}, n_iter=2, n_escore=-1, rot_matrices=rot)
    assert (_np(plain.adjust(_pr_tas(xp, 3, "2041-01-01"), _pr_tas(xp, 1), _pr_tas(xp, 2))) != out[xp]).any()


def test_mbcn_files_cross_the_packages(tmp_path, rots):
    """A trained MBCn saved by either package loads in the other with
    ``af_q``, ``escores`` and ``rot_matrices``, and adjusts to the same
    ``scen``."""
    want, scen_w = _train_adjust(xt, np.float64, "time", 3, rots)
    path = str(tmp_path / "ref")
    want.save(path)
    loaded = xp.MBCn.from_file(path)
    assert type(loaded) is xp.MBCn and loaded.group == xp.Grouper("time") and loaded.pts_dims == ["multivar", "multivar_prime"]
    for name in ("af_q", "escores", "rot_matrices"):
        np.testing.assert_array_equal(_np(loaded.ds[name]), np.asarray(want.ds[name].data))
    scen = loaded.adjust(_mv(xp, 3, start="2041-01-01"), _mv(xp, 1), _mv(xp, 2))
    np.testing.assert_allclose(_np(scen), np.asarray(scen_w.data), **F64)

    got, scen_g = _train_adjust(xp, np.float64, "time", 3, rots)
    back = str(tmp_path / "port")
    got.save(back)
    again = xp.MBCn.from_file(back)
    for name in ("af_q", "escores", "rot_matrices"):
        np.testing.assert_array_equal(_np(again.ds[name]), _np(got.ds[name]))
    np.testing.assert_array_equal(_np(again.adjust(_mv(xp, 3, start="2041-01-01"), _mv(xp, 1), _mv(xp, 2))), _np(scen_g))
    in_ref = xt.MBCn.from_file(back)
    np.testing.assert_allclose(np.asarray(in_ref.adjust(_mv(xt, 3, start="2041-01-01"), _mv(xt, 1), _mv(xt, 2)).data), _np(scen_g), **F64)


# ------------------------------------------------------------ NpdfTransform


NPDF_CASES = [
    (np.float64, "QuantileDeltaMapping", "time", "nearest"),
    (np.float32, "QuantileDeltaMapping", "time", "nearest"),
    (np.float64, "EmpiricalQuantileMapping", "time.season", "linear"),
    (np.float64, "QuantileDeltaMapping", "time.season", "nearest"),
]


@pytest.mark.parametrize("dtype,base,group,interp", NPDF_CASES)
def test_npdf_transform_matches_reference(rots, dtype, base, group, interp):
    """The public one-shot transform with both batched bases; a seasonal
    group goes through the grouped lookup (collapsed brackets for nearest)."""
    def run(mod):
        with mod.set_options(extra_output=True):
            return mod.NpdfTransform.adjust(
                _mv(mod, 1, dtype, nan=True), _mv(mod, 2, dtype), _mv(mod, 3, dtype, "2041-01-01"),
                base=getattr(mod, base), base_kws={"nquantiles": 8, "group": group}, adj_kws={"interp": interp},
                n_iter=3, n_escore=40, rot_matrices=rots[:3].astype(dtype),
            )

    want, got = run(xt), run(xp)
    assert sorted(got.keys()) == sorted(want.keys()) == ["escores", "scen", "scenh"]
    for name in ("scen", "scenh", "escores"):
        assert got[name].dims == want[name].dims, name
        g, w = _np(got[name]), np.asarray(want[name].data)
        assert g.dtype == dtype and g.shape == w.shape
        if name == "escores":
            np.testing.assert_allclose(g, w, **ESCORE[dtype])
        elif dtype is np.float64:
            np.testing.assert_allclose(g, w, **F64)
        else:
            off = np.abs(g - w) > 1e-4      # a rank on a nearest-node boundary takes the next node's factor
            assert np.nanmean(off) <= 0.01, np.nanmean(off)
    assert got["escores"].dims == ("site", "iterations")


def test_npdf_transform_plain_output_and_defaults(rots):
    """Without ``extra_output`` the result is ``scen`` in [multivar, ...,
    time] order; sim defaults to hist; ``kind`` in base_kws only warns."""
    ref, hist = _mv(xp, 1), _mv(xp, 2)
    scen = xp.NpdfTransform.adjust(ref, hist, n_iter=2, n_escore=-1, rot_matrices=rots[:2], base_kws={"nquantiles": 6})
    assert scen.dims == ("multivar", "site", "time") and scen.name == "scen"
    with pytest.warns(UserWarning, match="kind cannot be controlled"):
        again = xp.NpdfTransform.adjust(ref, hist, n_iter=2, n_escore=-1, rot_matrices=rots[:2], base_kws={"nquantiles": 6, "kind": "+"})
    np.testing.assert_array_equal(_np(again), _np(scen))


def _loop_inputs(mod):
    one = lambda s, start="1981-01-01": mod.DataArray(  # noqa: E731
        _mv(mod, s, start=start).data[0], ("multivar", "time"), {"time": mod.date_range(start, periods=T, freq="D", calendar="noleap"), "multivar": MV}, {"units": ""}, "d"
    )
    return one(1), one(2), one(3, "2041-01-01")


@pytest.mark.parametrize("base,adj_kws", [
    ("EmpiricalQuantileMapping", {"interp": "linear", "extrapolation": "constant"}),
    ("QuantileDeltaMapping", {"interp": "nearest", "extrapolation": "constant"}),
])
def test_npdf_general_loop_matches_reference(rots, base, adj_kws):
    """The arbitrary-base loop, run with EQM and QDM through their public
    train/adjust, against the reference's loop and the batched cores."""
    import jax.numpy as jnp

    from xsdba_tpu.models.mbcn import _npdf_loop_general as jloop
    from xsdba_tpu_torch.ops.correction import equally_spaced_nodes

    q = equally_spaced_nodes(8)
    ref, hist, sim = _loop_inputs(xt)
    lay = lambda da: jnp.moveaxis(jnp.asarray(da.data), 0, -2)  # noqa: E731
    want = jloop(xt.NpdfTransform, getattr(xt, base), {"kind": "+"}, adj_kws, xt.Grouper("time"), q, ref, hist, sim,
                 lay(ref), lay(hist), lay(sim), jnp.asarray(rots[:3]), 40)
    ref, hist, sim = _loop_inputs(xp)
    tlay = lambda da: torch.movedim(torch.as_tensor(da.data), 0, -2)  # noqa: E731
    got = tmbcn._npdf_loop_general(getattr(xp, base), {"kind": "+"}, adj_kws, xp.Grouper("time"), q, ref, hist, sim,
                                   tlay(ref), tlay(hist), tlay(sim), torch.as_tensor(rots[:3]), 40)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **ESCORE[np.float64])
    with xp.set_options(extra_output=True):
        fast = xp.NpdfTransform.adjust(ref, hist, sim, base=getattr(xp, base), base_kws={"nquantiles": 8}, adj_kws=adj_kws,
                                       n_iter=3, n_escore=40, rot_matrices=rots[:3])
    np.testing.assert_allclose(np.moveaxis(got[1].numpy(), -2, 0), _np(fast["scen"]), rtol=1e-9, atol=1e-9)


def test_npdf_general_loop_with_scaling(rots):
    """A third base, one whose ``train`` takes no ``nquantiles``: the port
    trains it without (the JAX package hands ``nquantiles`` to every base
    and refuses Scaling with a TypeError), and equals the reference's loop
    written out by hand with its Scaling class."""
    import jax.numpy as jnp

    adj_kws = {"interp": "nearest"}
    ref, hist, sim = _loop_inputs(xp)
    with xp.set_options(extra_output=True):
        got = xp.NpdfTransform.adjust(ref, hist, sim, base=xp.Scaling, base_kws={"group": "time.season"}, adj_kws=adj_kws,
                                      n_iter=3, n_escore=-1, rot_matrices=rots[:3])
    assert np.isnan(_np(got["escores"])).all()

    jref, jhist, jsim = _loop_inputs(xt)
    with pytest.raises(TypeError, match="nquantiles"):
        xt.NpdfTransform.adjust(jref, jhist, jsim, base=xt.Scaling, base_kws={"group": "time.season"}, adj_kws=adj_kws, n_iter=1, rot_matrices=rots[:1])
    wrap = lambda a, like: xt.DataArray(a, like.dims, dict(like.coords), dict(like.attrs), like.name)  # noqa: E731
    r, h, s = (jnp.asarray(d.data) for d in (jref, jhist, jsim))
    for R in rots[:3]:
        rp, hp, sp = (jnp.einsum("ij,jl->il", R, a) for a in (r, h, s))
        adj = xt.Scaling.train(wrap(rp, jref), wrap(hp, jhist), group="time.season", kind="+", skip_input_checks=True)
        h = jnp.einsum("ji,jl->il", R, jnp.asarray(adj.adjust(wrap(hp, jhist), skip_input_checks=True, **adj_kws).data))
        s = jnp.einsum("ji,jl->il", R, jnp.asarray(adj.adjust(wrap(sp, jsim), skip_input_checks=True, **adj_kws).data))
    np.testing.assert_allclose(_np(got["scen"]), np.asarray(s), **F64)
    np.testing.assert_allclose(_np(got["scenh"]), np.asarray(h), **F64)


# ------------------------------------------------------------ frozen cases


def _port_mv(da):
    t = da.coords["time"]
    time = xp.date_range(f"{int(t.year[0]):04d}-{int(t.month[0]):02d}-{int(t.day[0]):02d}", periods=len(t), freq="D", calendar=t.calendar)
    coords = {"time": time, "multivar": np.asarray(da.coords["multivar"])}
    return xp.DataArray(torch.as_tensor(np.array(da.data)), da.dims, coords, dict(da.attrs), da.name)


def _reference_draw(n_features, n_iter):
    """The rotations the reference draws in an e2e case: the stream seeded
    with ``JAX_SEED``, ``max(n_iter, 2)`` matrices, the first ``n_iter``."""
    jax_seed(JAX_SEED)
    return np.asarray(rand_rot_matrix(n_features, num=max(n_iter, 2)))[:n_iter]


def test_e2e_cases_match_frozen():
    """The ``NpdfTransform`` and ``MBCn`` cases of ``tests/e2e_cases.py``
    replayed through the port with the reference's draws injected, against
    the frozen reference outputs."""
    frozen = np.load(FROZEN)
    d = {k: _port_mv(v) for k, v in build_inputs().items() if k.startswith("mv_")}
    scen = xp.NpdfTransform.adjust(d["mv_ref"], d["mv_hist"], n_iter=3, n_escore=-1, rot_matrices=_reference_draw(2, 3))
    np.testing.assert_allclose(_np(scen), frozen["NpdfTransform"], rtol=1e-9, atol=1e-9)
    mbcn = xp.MBCn.train(d["mv_ref"], d["mv_hist"], base_kws={"nquantiles": 10}, n_iter=2, n_escore=-1, rot_matrices=_reference_draw(2, 2))
    scen = mbcn.adjust(d["mv_sim"], d["mv_ref"], d["mv_hist"])
    np.testing.assert_allclose(_np(scen), frozen["MBCn"], rtol=1e-9, atol=1e-9)


def test_workflow_with_stack_variables():
    """The documented usage: a Dataset of variables stacked, adjusted and
    unstacked, with the variables' attrs coming back."""
    t = xp.date_range("1981-01-01", periods=T, freq="D", calendar="noleap")
    t2 = xp.date_range("2041-01-01", periods=T, freq="D", calendar="noleap")
    rng = np.random.default_rng(9)

    def ds(time, shift):
        return xp.Dataset({
            "tas": xp.DataArray(rng.normal(280 + shift, 3, T), ("time",), {"time": time}, {"units": "K"}, "tas"),
            "pr": xp.DataArray(rng.gamma(2, 2, T), ("time",), {"time": time}, {"units": "mm/d"}, "pr"),
        })

    ref, hist, sim = (xp.processing.stack_variables(ds(tt, s)) for tt, s in ((t, 0), (t, 2), (t2, 3)))
    mbcn = xp.MBCn.train(ref, hist, base_kws={"nquantiles": 10, "group": xp.Grouper("time.dayofyear", window=5)}, n_iter=2)
    out = xp.processing.unstack_variables(mbcn.adjust(sim, ref, hist))
    assert sorted(out.keys()) == ["pr", "tas"] and out["tas"].attrs["units"] == "K" and out["pr"].attrs["units"] == "mm/d"
    assert isinstance(out["tas"].data, torch.Tensor) and np.isfinite(_np(out["tas"])).all()
    assert abs(float(_np(out["tas"]).mean()) - 281) < 1.5       # ref's mean plus the simulated change
