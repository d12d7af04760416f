"""The N-pdf transform cores of the port against the JAX package, on the CPU.

The same numpy inputs, and the same rotations (drawn once by the reference:
a ``torch.Generator`` cannot reproduce its Threefry stream), go through
``xsdba_tpu.models._npdft`` and ``xsdba_tpu_torch.models._npdft``.

Tolerances.  One rotation from an injected state is held tight (1e-12 in
float64, 2e-6 in float32).  The V x V rotation itself is a ``torch.matmul``:
XLA's CPU backend sums the V products in an order that changes with V, the
dtype and the transposition (a written-out fused chain in index order equals
it for V <= 3 untransposed and nothing else tried does for V = 3 transposed,
5 or 8), so no written-out sum was kept, and each rotation may differ by an
ulp of the state.  The state's mean and standard deviation are sums in
another order too.  Over several iterations those ulps add up, and ranks are
discontinuous (an ulp can swap two order statistics), so ``af_q`` is compared
by value at 1e-10 (float64) and 5e-5 (float32, 20 iterations; observed 1e-5),
never by index.  The energy score is a difference of three sums of N x M
distances scaled by N/2: cancellation amplifies the summation order to 1e-8
relative in float64 and 4e-4 in float32, held at 1e-6 and 2e-3.
"""

import numpy as np
import pytest
import torch

import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu.models import _npdft as J
from xsdba_tpu.ops.escore import escore as jescore
from xsdba_tpu.ops.rotation import rand_rot_matrix
from xsdba_tpu_torch.models import _npdft as T
from xsdba_tpu_torch.ops import escore as tescore


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


DTYPES = [np.float64, np.float32]
TIGHT = {np.float64: dict(rtol=1e-12, atol=1e-12), np.float32: dict(rtol=2e-6, atol=2e-6)}
AF_Q = {np.float64: dict(rtol=0, atol=1e-10), np.float32: dict(rtol=0, atol=5e-5)}
ESCORE = {np.float64: dict(rtol=1e-6, atol=1e-9), np.float32: dict(rtol=2e-3, atol=1e-5)}
V, L = 3, 400
Q = np.linspace(0.025, 0.975, 20)


def _t(*arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


@pytest.fixture(scope="module")
def rots():
    """20 rotations drawn once by the reference, in float64."""
    from xsdba_tpu.utils.rng import seed

    seed(7)
    return np.array(rand_rot_matrix(V, num=20, dtype=np.float64))


def _blocks(dtype, seed=0, gaps=True):
    """ref, hist [2, V, L]: correlated normals; with ``gaps`` a few NaN
    values, a NaN-padded tail (a windowed block's padding) and, at site 1, an
    all-NaN variable."""
    rng = np.random.default_rng(seed)
    ref = rng.normal(0, 1, (2, V, L))
    hist = rng.normal(0.5, 1.3, (2, V, L)) + 0.4 * ref[:, ::-1]
    if gaps:
        hist[0, 0, 5:9] = np.nan
        ref[0, :, -7:] = np.nan
        hist[0, :, -7:] = np.nan
        hist[1, 2] = np.nan
    return ref.astype(dtype), hist.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_standardize_lastaxis(dtype):
    ref, hist = _blocks(dtype)
    got = T.standardize_lastaxis(*_t(hist))
    want = np.asarray(J.standardize_lastaxis(hist))
    assert got.dtype == torch.from_numpy(hist).dtype
    np.testing.assert_allclose(got.numpy(), want, equal_nan=True, **TIGHT[dtype])
    assert np.isnan(got.numpy()[1, 2]).all()
    np.testing.assert_allclose(np.nanstd(got.numpy()[0], axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_composed_rots(rots, dtype):
    r = rots.astype(dtype)
    got = T._composed_rots(*_t(r)).numpy()
    np.testing.assert_allclose(got, np.asarray(J._composed_rots(r)), **TIGHT[dtype])
    np.testing.assert_array_equal(got[0], r[0])
    # the increments compose back to the rotations
    acc = r[0].astype(np.float64)
    for i in range(1, 4):
        acc = got[i].astype(np.float64) @ acc
        np.testing.assert_allclose(acc, r[i], atol=1e-5 if dtype is np.float32 else 1e-12)


@pytest.mark.parametrize("interp", ["nearest", "linear"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_one_training_rotation_from_an_injected_state(rots, dtype, interp):
    """One rotation of the training loop on a given (not re-standardized)
    state: the rotation, both quantile tables, the shared-sort ranks and the
    factor lookup, tight."""
    ref, hist = _blocks(dtype)
    kw = dict(interp=interp, extrap="constant", n_escore=-1, standardize=False)
    r1, q = rots[3:4].astype(dtype), Q.astype(dtype)
    want_af, want_esc = J.npdft_train_core(ref, hist, r1, q, **kw)
    got_af, got_esc = T.npdft_train_core(*_t(ref, hist, r1, q), **kw)
    assert tuple(got_af.shape) == (2, 1, V, len(Q)) and tuple(got_esc.shape) == (2, 1)
    np.testing.assert_allclose(got_af.numpy(), np.asarray(want_af), equal_nan=True, **TIGHT[dtype])
    assert np.isnan(got_esc.numpy()).all() and np.isnan(np.asarray(want_esc)).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_adjust_rotation_from_an_injected_state(rots, dtype):
    """One rotation of the adjust loop: rotate, rank, look the stored factors
    up, add, rotate back."""
    ref, hist = _blocks(dtype, seed=1)
    r1, q = rots[5:6].astype(dtype), Q.astype(dtype)
    af_q = np.asarray(J.npdft_train_core(ref, hist, r1, q, interp="nearest", extrap="constant", n_escore=-1)[0])
    kw = dict(interp="nearest", extrap="constant")
    want = np.asarray(J.npdft_adjust_core(hist, af_q, r1, q, **kw))
    got = T.npdft_adjust_core(*_t(hist, af_q, r1, q), **kw).numpy()
    np.testing.assert_allclose(got, want, equal_nan=True, **TIGHT[dtype])


@pytest.mark.parametrize("n_iter", [3, 20])
@pytest.mark.parametrize("dtype", DTYPES)
def test_npdft_train_core(rots, dtype, n_iter):
    """The whole training loop, standardization and energy scores included,
    with NaN gaps, a padded tail and an all-NaN variable.

    float64 holds every rotation at 1e-10.  In float32 the states may part
    between back ends once an ulp moves a rank across a ``nearest`` node in
    a rotation's adjustment (ROADMAP C12), and from then on for good: the
    factors of the next rotation, ``p``, are the first to differ by more
    than 5e-5, and the score of rotation ``p - 1`` is the first taken on a
    parted state.  So float32 holds the NaN pattern, every rotation before
    ``p`` at 5e-5, the first rotation included (``p >= 1``), and the scores
    before ``p - 1`` at 2e-3.  From ``p`` on it holds at most 95 % of the
    finite factors off by more than 5e-5, each within the reference
    factors' range, and the scores at 5e-2.  Readings at 20 rotations: on
    one x86-64 CPU the states part at p = 9, 85 % of the later factors are
    off, by at most 9 % of the range, and the scores by at most 2.2e-2
    (before rotation 8 by at most 9e-5); the port on a second machine's CPU,
    against the reference's result from the first, does not part (p = 20,
    every factor within 9e-6; ``scripts/npdft_parting.py`` takes them)."""
    ref, hist = _blocks(dtype)
    kw = dict(interp="nearest", extrap="constant", n_escore=100)
    r, q = rots[:n_iter].astype(dtype), Q.astype(dtype)
    want_af, want_esc = (np.asarray(a) for a in J.npdft_train_core(ref, hist, r, q, **kw))
    got_af, got_esc = (a.numpy() for a in T.npdft_train_core(*_t(ref, hist, r, q), **kw))
    assert got_af.shape == want_af.shape == (2, n_iter, V, len(Q)) and got_esc.shape == want_esc.shape
    assert got_af.dtype == dtype
    # the site with an all-NaN variable has no complete point: no score
    assert np.isnan(got_esc[1]).all() and np.isnan(want_esc[1]).all()
    if dtype is np.float64:
        np.testing.assert_allclose(got_af, want_af, equal_nan=True, **AF_Q[dtype])
        np.testing.assert_allclose(got_esc[0], want_esc[0], **ESCORE[dtype])
        return
    np.testing.assert_array_equal(np.isnan(got_af), np.isnan(want_af))
    atol = AF_Q[dtype]["atol"]
    off = np.nanmax(np.abs(got_af - want_af), axis=(0, 2, 3)) > atol        # [n_iter]
    p = int(np.argmax(off)) if off.any() else n_iter
    assert p >= 1, "the first rotation's factors differ by more than 5e-5"
    np.testing.assert_allclose(got_af[:, :p], want_af[:, :p], equal_nan=True, **AF_Q[dtype])
    np.testing.assert_allclose(got_esc[0, : max(p - 1, 0)], want_esc[0, : max(p - 1, 0)], **ESCORE[dtype])
    diff = np.abs(got_af - want_af)[:, p:][np.isfinite(want_af[:, p:])]
    if diff.size:
        assert np.mean(diff > atol) <= 0.95, (p, np.mean(diff > atol))
        assert diff.max() <= np.nanmax(want_af) - np.nanmin(want_af)
    np.testing.assert_allclose(got_esc[0, max(p - 1, 0) :], want_esc[0, max(p - 1, 0) :], rtol=5e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_npdft_train_core_skips_the_score_at_zero(rots, dtype):
    """The reference's asymmetry: training scores only for n_escore > 0."""
    ref, hist = _blocks(dtype, gaps=False)
    _, esc = T.npdft_train_core(*_t(ref, hist, rots[:2].astype(dtype), Q.astype(dtype)), interp="nearest", extrap="constant", n_escore=0)
    assert torch.isnan(esc).all()


@pytest.mark.parametrize("n_iter", [3, 20])
@pytest.mark.parametrize("dtype", DTYPES)
def test_npdft_adjust_core(rots, dtype, n_iter):
    """Stored factors replayed on another series.  In float32 an ulp of the
    rotated state can move a rank across a nearest-node boundary, which
    changes that value's factor by a node step: nearly all values agree
    within 1e-4 and the few that do not stay within the factors' range."""
    ref, hist = _blocks(dtype, seed=2)
    sim = np.random.default_rng(5).normal(0.7, 1.2, hist.shape).astype(dtype)
    sim[0, 1, 11] = np.nan
    r, q = rots[:n_iter].astype(dtype), Q.astype(dtype)
    af_q = np.asarray(J.npdft_train_core(ref, hist, r, q, interp="nearest", extrap="constant", n_escore=-1)[0])
    kw = dict(interp="nearest", extrap="constant")
    want = np.asarray(J.npdft_adjust_core(sim, af_q, r, q, **kw))
    got = T.npdft_adjust_core(*_t(sim, af_q, r, q), **kw).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if dtype is np.float64:
        np.testing.assert_allclose(got, want, equal_nan=True, rtol=0, atol=1e-10)
    else:
        off = np.abs(got - want) > 1e-4
        assert np.nanmean(off) <= 0.01, np.nanmean(off)
        assert np.nanmax(np.abs(got - want)) <= np.nanmax(np.abs(af_q[0])) * n_iter


def _transform_args(mod, group, dtype, seed=3):
    """Arguments of ``npdf_transform_core`` for ``mod`` (xt or xp): ref,
    hist [2, V, Th] and sim [2, V, Ts] with NaN gaps, and both calendars'
    group indexes."""
    rng = np.random.default_rng(seed)
    Th = Ts = 365 * 2
    ref = rng.normal(0, 1, (2, V, Th))
    hist = rng.normal(0.5, 1.3, (2, V, Th)) + 0.4 * ref[:, ::-1]
    sim = rng.normal(0.8, 1.4, (2, V, Ts))
    hist[0, 0, 5:9] = np.nan
    sim[1, 2, 100:103] = np.nan
    th = mod.date_range("1981-01-01", periods=Th, freq="D", calendar="noleap")
    ts = mod.date_range("2041-01-01", periods=Ts, freq="D", calendar="noleap")
    g = mod.Grouper(*group)
    gh, gs = g.indexes(th), g.indexes(ts)
    idx = (gh.gather_idx, gh.group_idx, gh.scatter_slot, gs.gather_idx, gs.group_idx, gs.scatter_slot)
    frac = (gh.frac_idx, gh.positions, gs.frac_idx, gs.positions)
    return tuple(a.astype(dtype) for a in (ref, hist, sim)), idx, frac


TRANSFORM_CASES = [
    (np.float64, ("time", 1), "qdm", "nearest"),
    (np.float32, ("time", 1), "qdm", "nearest"),
    (np.float64, ("time", 1), "eqm", "linear"),
    (np.float64, ("time.dayofyear", 5), "qdm", "nearest"),
    (np.float32, ("time.dayofyear", 5), "qdm", "nearest"),
    (np.float64, ("time.dayofyear", 5), "eqm", "linear"),
    (np.float32, ("time.dayofyear", 5), "eqm", "linear"),
    (np.float32, ("time.dayofyear", 5), "qdm", "linear"),
]


@pytest.mark.parametrize("dtype,group,base,interp", TRANSFORM_CASES, ids=lambda v: getattr(v, "__name__", None) or (v if isinstance(v, str) else f"{v[0]}-{v[1]}"))
def test_npdf_transform_core(rots, dtype, group, base, interp):
    """The NpdfTransform engine, both bases, ungrouped and on a 5-day
    dayofyear window (the grouped lookup), three rotations."""
    (ref, hist, sim), idx_j, frac_j = _transform_args(xt, group, dtype)
    _, idx_t, frac_t = _transform_args(xp, group, dtype)
    r, q = rots[:3].astype(dtype), Q.astype(dtype)
    kw = dict(interp=interp, extrap="constant", n_escore=60, base=base)
    want = [np.asarray(a) for a in J.npdf_transform_core(ref, hist, sim, r, q, *idx_j, *(np.asarray(f, dtype) for f in frac_j), **kw)]
    got = [a.numpy() for a in T.npdf_transform_core(*_t(ref, hist, sim, r, q), *idx_t, *frac_t, **kw)]
    for g, w, name in zip(got, want, ("scenh", "scens", "escores")):
        assert g.shape == w.shape and g.dtype == dtype, name
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        if dtype is np.float64:
            np.testing.assert_allclose(g, w, equal_nan=True, rtol=0, atol=1e-10)
        else:
            # a rank or a value on a node boundary may take the next node's factor
            off = np.abs(g - w) > 1e-4
            assert np.nanmean(off) <= 0.01, np.nanmean(off)
    np.testing.assert_allclose(got[2], want[2], **ESCORE[dtype])


def test_npdf_transform_core_scores_at_zero_and_skips_below(rots):
    """n_escore = 0 scores on all points (the reference's ``>= 0``), -1 not."""
    (ref, hist, sim), idx, frac = _transform_args(xp, ("time", 1), np.float64)
    args = _t(ref[..., :120], hist[..., :120], sim[..., :120], rots[:2], Q)
    gi = xp.Grouper("time").indexes(xp.date_range("1981-01-01", periods=120, freq="D", calendar="noleap"))
    idx = (gi.gather_idx, gi.group_idx, gi.scatter_slot) * 2
    frac = (gi.frac_idx, gi.positions) * 2
    kw = dict(interp="nearest", extrap="constant")
    assert torch.isfinite(T.npdf_transform_core(*args, *idx, *frac, n_escore=0, **kw)[2]).all()
    assert torch.isnan(T.npdf_transform_core(*args, *idx, *frac, n_escore=-1, **kw)[2]).all()


# ------------------------------------------------------------------- escore


def _clusters(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (4, V, 40))
    y = rng.normal(0.5, 1, (4, V, 50))
    y[1, 0, 3] = np.nan      # one incomplete point
    x[2, :, :] = np.nan      # an empty cluster
    return x.astype(dtype), y.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_escore_matches_reference(dtype):
    x, y = _clusters(dtype)
    got = tescore.escore(*_t(x, y)).numpy()
    want = np.asarray(jescore(x, y))
    assert got.shape == (4,) and got.dtype == dtype
    np.testing.assert_allclose(got, want, equal_nan=True, **ESCORE[dtype])
    assert np.isnan(got[2]) and np.isfinite(got[[0, 1, 3]]).all()


def test_escore_matches_a_naive_double_loop():
    x, y = _clusters(np.float64)
    got = tescore.escore(*_t(x, y)).numpy()
    for b in (0, 1, 3):
        xs = x[b][:, ~np.isnan(x[b]).any(0)].T
        ys = y[b][:, ~np.isnan(y[b]).any(0)].T
        n2, n1 = len(xs), len(ys)
        sxy = sum(np.sqrt(((p - r) ** 2).sum()) for p in xs for r in ys) / (n1 * n2)
        sxx = sum(np.sqrt(((p - r) ** 2).sum()) for p in xs for r in xs) / n2**2
        syy = sum(np.sqrt(((p - r) ** 2).sum()) for p in ys for r in ys) / n1**2
        # the factored distance loses digits on close pairs: 1e-9 observed
        np.testing.assert_allclose(got[b], n1 * n2 / (n1 + n2) * (2 * sxy - sxx - syy) / 2, rtol=1e-7)


@pytest.mark.parametrize("dtype", DTYPES)
def test_escore_does_not_depend_on_the_chunking(monkeypatch, dtype):
    """The leading batch is walked in chunks under an element budget; a
    budget of one site a chunk, two, or all gives the same bits, with
    broadcast leading dims too."""
    x, y = _clusters(dtype, seed=4)
    x = x.reshape(2, 2, V, 40)
    y = y.reshape(2, 2, V, 50)[:1]                 # broadcast over the first dim
    whole = tescore.escore(*_t(x, y))
    assert tuple(whole.shape) == (2, 2)
    for budget in (1, 2 * 50 * 50, 3 * 50 * 50):
        monkeypatch.setattr(tescore, "_BLOCK_BUDGET", budget)
        torch.testing.assert_close(tescore.escore(*_t(x, y)), whole, rtol=0, atol=0, equal_nan=True)
