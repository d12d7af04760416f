"""The port on an NVIDIA GPU: the CUDA kernels against their plain twins,
the public QDM and windowed EQM paths (merge and selection engines) and
the diagnostics (the GEV fit, the incomplete beta, run lengths, the
inter-site Spearman product, every property's device) on the card against
the port's CPU path.  Numpy data runs on the card by
default here (the ``device`` option is left at "cuda").

Every test here needs a card (and ``nvcc`` to build the kernels) and skips
without one.  The file imports no JAX, so it also runs where JAX is absent;
there, bypass ``tests/conftest.py`` (which imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

import xsdba_tpu_torch as xp
from chip_smoke import (
    FLIP_RTOL,
    LOESS_RTOL,
    SeededDraws,
    bracket_inputs,
    config2_adjust,
    config2_train,
    dqm_doy_adjust,
    dqm_doy_train,
    example_problem,
    fma_inputs,
    heavy_problem,
    held_with_flips,
    lookup_inputs,
    nan_masked,
    pair_sorted,
    pr_problem,
    resort_oracle,
    run_main_path,
    run_windowed_path,
    sort_inputs,
)
from xsdba_tpu_torch.ops import interp, merge, selquant, sort
from xsdba_tpu_torch.ops.correction import equally_spaced_nodes
from xsdba_tpu_torch.ops.cuda import fma_kernel
from xsdba_tpu_torch.ops.cuda import interp_kernel as k
from xsdba_tpu_torch.ops.cuda.fma_kernel import fma
from xsdba_tpu_torch.ops.loess import loess_smoothing

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _nan_equal(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("B,Gp,Lp,nq", [
    (1, 3, 1, 2),        # one value per row
    (2, 14, 2049, 50),   # a row just over one block's tile
    (4, 7, 333, 64),     # the widest table
    (3, 5, 100, 1),      # one-node tables
    (64, 14, 4650, 50),  # headline partition rows, fewer sites
    (5, 4, 3, 2),        # all head, two-node tables
    (16, 367, 150, 50),  # the windowed adjust's short rows: a warp a row
    (3, 11, 150, 64),    # a row count that leaves a block part empty
    (3, 5, 1023, 50),    # the longest row a warp takes (lengths off a multiple of 4)
    (3, 5, 1024, 50),    # the shortest row a block takes
    (3, 5, 1025, 1),
    (2, 3, 4096, 33),    # one full tile
    (2, 3, 4097, 17),    # a tile and one value
])
def test_kernel_matches_twin_bitwise(cuda, B, Gp, Lp, nq):
    v, xs, ys, nv = lookup_inputs(B, Gp, Lp, nq, seed=B + Lp, device=cuda, extra=True)
    before = k.launches
    got = k.interp_table_3d(v, xs, ys, nv)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert got.is_cuda and got.dtype == torch.float32 and got.shape == v.shape
    assert _nan_equal(got, k.interp_table_3d_reference(v, xs, ys, nv))


@pytest.mark.parametrize("Lp", [7, 150, 4650])
@pytest.mark.parametrize("shift", [1, 2, 3])
def test_kernel_on_values_off_16_bytes(cuda, Lp, shift):
    """A contiguous view that starts 4, 8 or 12 bytes off a 16-byte boundary
    takes the scalar path."""
    v, xs, ys, nv = lookup_inputs(3, 5, Lp, 50, seed=Lp + shift, device=cuda, extra=True)
    off = torch.cat([v.new_zeros(shift), v.reshape(-1)])[shift:].reshape(v.shape)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4 * shift
    got = k.interp_table_3d(off, xs, ys, nv)
    torch.cuda.synchronize()
    assert _nan_equal(got, k.interp_table_3d_reference(v, xs, ys, nv))


def test_kernel_rejects_tables_on_another_device(cuda):
    v, xs, ys, nv = lookup_inputs(1, 3, 8, 4, device=cuda)
    with pytest.raises(ValueError):
        k.interp_table_3d(v, xs.cpu(), ys, nv)


def test_public_qdm_on_cuda_matches_cpu(cuda):
    t, data = example_problem(16, 4)
    k.launches = k.launches_bracketed = 0
    got = run_main_path(*(torch.from_numpy(a).to(cuda) for a in data), t)
    torch.cuda.synchronize()
    # one adjust: both brackets' lookups and the blend in one bracketed launch
    assert (k.launches_bracketed, k.launches) == (1, 0) and got.is_cuda and bool(torch.isfinite(got).all())
    want = run_main_path(*(torch.from_numpy(a) for a in data), t)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-6, atol=2e-6)


def test_trained_parameters_follow_the_data_to_the_card(cuda):
    """A trained object whose parameters are numpy arrays adjusts CUDA data
    on the card."""
    t, (ref, hist, sim) = example_problem(4, 3)
    mk = lambda x: xp.DataArray(x, ("site", "time"), {"time": t}, {"units": "K"})  # noqa: E731
    qdm = xp.QuantileDeltaMapping.train(mk(torch.from_numpy(ref)), mk(torch.from_numpy(hist)), group="time.month", nquantiles=20)
    built = xp.QuantileDeltaMapping.from_params(
        qdm.ds["af"].data.numpy(), qdm.ds["hist_q"].data.numpy(), np.asarray(qdm.ds["af"].coords["quantiles"]),
        group="time.month", kind="+",
    )
    got = built.adjust(mk(torch.from_numpy(sim).to(cuda)), interp="linear").data
    assert got.is_cuda
    want = qdm.adjust(mk(torch.from_numpy(sim)), interp="linear").data
    torch.testing.assert_close(got.cpu(), want, rtol=2e-6, atol=2e-6)


# ------------------------------------------------------------ merge kernels


def _slab(B, Dp, m, ymax, seed, dtype=torch.float32, device="cpu"):
    """[B, Dp, m] rows with +inf past ``ymax`` values, ties and signed zeros."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(0, 2, (B, Dp, m)), 1)
    x[:, :, ymax:] = np.inf
    x[:, ::7, :3] = 0.0
    x[:, 3::7, :3] = -0.0
    x = x[..., rng.permutation(m)]
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


def _equal(a, b):
    return bool((a == b).all())


def _same_bits(a, b, run):
    """Each run of ``run`` consecutive values of ``a`` holds the bit patterns
    of the same run of ``b`` (a permutation: -0.0 and +0.0 kept apart)."""
    bits = torch.int32 if a.dtype == torch.float32 else torch.int64
    key = lambda t: torch.sort(t.contiguous().view(bits).reshape(-1, run), dim=-1).values  # noqa: E731
    return bool((key(a) == key(b)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,Dp,m", [(1, 2, 1), (3, 8, 2), (4, 64, 16), (2, 400, 256), (1, 6, 2048)])
def test_row_sort_matches_twin(cuda, dtype, B, Dp, m):
    x = _slab(B, Dp, m, max(m - 3, 1), seed=m, dtype=dtype, device=cuda)
    before = merge.launches["sort_rows_alternating"]
    got = merge.sort_rows_alternating(x)
    torch.cuda.synchronize()
    assert merge.launches["sort_rows_alternating"] == before + 1 and got.is_cuda
    assert _equal(got, merge.sort_rows_alternating_reference(x))


@pytest.mark.parametrize("case", ["values", "ties", "all inf"])
@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, "limit"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_sort_at_every_lane_width(cuda, dtype, m, case):
    """The warp sort at every values-a-lane (m <= 1024), the long-row variant
    above it up to its limit (the longest power-of-two row within 48 KB:
    8192 f32, 4096 f64); row counts that leave a block, and for m < 32 a
    warp, part empty; the output a permutation of the input's bits."""
    elem = torch.empty((), dtype=dtype).element_size()
    m = 32 * 1024 // elem if m == "limit" else m
    assert merge.row_sort_in_warp(m) is (m <= 1024)
    B, Dp = {"values": (5, 34), "ties": (3, 6), "all inf": (2, 8)}[case]
    if case == "values":
        x = _slab(B, Dp, m, max(m - 3, 1), seed=m, dtype=dtype, device=cuda)
    elif case == "ties":
        x = _tie_slab(B, Dp, m, max(m // 2, 1), seed=m, dtype=dtype, device=cuda)
    else:
        x = torch.full((B, Dp, m), torch.inf, dtype=dtype, device=cuda)
    before = merge.launches["sort_rows_alternating"]
    got = merge.sort_rows_alternating(x)
    torch.cuda.synchronize()
    assert merge.launches["sort_rows_alternating"] == before + 1
    assert _equal(got, merge.sort_rows_alternating_reference(x))
    assert _same_bits(got, x, m)


@pytest.mark.parametrize("dtype,levels,m", [
    *((d, L, m) for d in (torch.float32, torch.float64) for L in (3, 4) for m in (1, 2, 8, 32, 256, 1024)),
    (torch.float64, 4, 1024),   # 256 KB of buffers: merged in device memory (the 900-value fold's slab)
    (torch.float64, 3, 2048),
    (torch.float32, 4, 2048),
    (torch.float32, 3, 3),      # rows of odd length (ordered by the twin)
    (torch.float32, 1, 3),      # level spans off 16 bytes: the stores' head
    (torch.float64, 2, 150),
])
def test_level_build_in_one_launch(cuda, dtype, levels, m):
    """Both level build variants, chosen by shape, against the twin; every
    level in one launch."""
    elem = torch.empty((), dtype=dtype).element_size()
    shared = merge.levels_in_shared(m, levels, elem, merge.fold_smem_limit(dtype, cuda))
    assert shared is (2 * (m << levels) * elem < 256 * 1024)  # the cases here need at most 128 KB, or 256 KB
    Dp = 3 << levels
    for x in (_slab(2, Dp, m, max(m - 1, 1), seed=m + levels, dtype=dtype), _tie_slab(2, Dp, m, m, seed=m, dtype=dtype, device="cpu")):
        ordered = merge.sort_rows_alternating_reference(x).to(cuda)
        before = merge.launches["build_levels"]
        got = merge.build_levels(ordered, levels)
        torch.cuda.synchronize()
        assert merge.launches["build_levels"] == before + 1
        assert tuple(got.shape) == (2, levels, Dp, m)
        assert _equal(got, merge.build_levels_reference(ordered, levels))
        assert all(_same_bits(got[:, k], ordered, (2 << k) * m) for k in range(levels))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("window,m,ymax", [(9, 16, 11), (13, 32, 20), (24, 16, 16), (31, 256, 150), (31, 8, 5)])
def test_level_build_and_fold_match_twins(cuda, dtype, window, m, ymax):
    G, L = 40, merge.n_levels(window)
    Dp = -(-(G - 1 + window) // (1 << L)) * (1 << L)
    ordered = merge.sort_rows_alternating(_slab(3, Dp, m, ymax, seed=window, dtype=dtype, device=cuda))
    levels = merge.build_levels(ordered, L)
    torch.cuda.synchronize()
    assert _equal(levels, merge.build_levels_reference(ordered, L))
    got = merge.fold_windows(ordered, levels, window, G, ymax=ymax)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (3, G, window * ymax)
    assert _equal(got, merge.fold_windows_reference(ordered, levels, window, G, window * ymax))
    assert _equal(got, merge.merged_window_rows_reference(ordered, window, G, window * ymax))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("window", [1, 3, 5, 8])
def test_per_group_merge_matches_twin(cuda, window, dtype):
    G, m, ymax = 30, 32, 20
    ordered = merge.sort_rows_alternating(_slab(4, 40, m, ymax, seed=window, dtype=dtype, device=cuda))
    before = merge.launches["merged_window_rows"]
    got = merge.merged_window_rows(ordered, window, G, ymax=ymax)
    torch.cuda.synchronize()
    assert merge.launches["merged_window_rows"] == before + 1
    assert _equal(got, merge.merged_window_rows_reference(ordered, window, G, window * ymax))


def test_merge_wrappers_raise_past_their_limits(cuda):
    with pytest.raises(ValueError, match="shared memory"):
        merge.sort_rows_alternating(torch.zeros((1, 2, 16384), device=cuda))
    ordered = merge.sort_rows_alternating(_slab(1, 48, 4096, 4096, seed=1, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        merge.merged_window_rows(ordered, 31, 4)
    # the fold takes every row whose staging buffer fits, and no longer row
    limit = merge.fold_smem_limit(torch.float32, cuda)
    ymax = limit // (31 * 4)
    ordered = merge.sort_rows_alternating(_slab(1, 40, 2048, ymax, seed=2, device=cuda))
    got = merge.merged_window_rows(ordered, 31, 2, ymax=ymax)
    torch.cuda.synchronize()
    assert _equal(got, merge.merged_window_rows_reference(ordered, 31, 2, 31 * ymax))
    with pytest.raises(ValueError, match="shared memory"):
        merge.merged_window_rows(ordered, 31, 2, ymax=ymax + 1)


@pytest.mark.parametrize("call", ["fold", "merge"])
def test_f64_window_31_of_900_values_runs(cuda, call):
    """f64, window 31, ymax 900, m 1024: 223,200 bytes of merged row, the
    fold's second buffer in the output row; it ran before the merge-path
    redesign and must still run."""
    G, m, ymax, L = 3, 1024, 900, merge.n_levels(31)
    assert not merge.fold_scratch_in_shared(31 * ymax, 8, merge.fold_smem_limit(torch.float64, cuda))
    ordered = merge.sort_rows_alternating(_slab(2, 48, m, ymax, seed=31, dtype=torch.float64, device=cuda))
    if call == "fold":
        assert not merge.levels_in_shared(m, L, 8, merge.fold_smem_limit(torch.float64, cuda))
        levels = merge.build_levels(ordered, L)
        assert _equal(levels, merge.build_levels_reference(ordered, L))
        got = merge.fold_windows(ordered, levels, 31, G, ymax=ymax)
    else:
        got = merge.merged_window_rows(ordered, 31, G, ymax=ymax)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (2, G, 31 * ymax)
    assert _equal(got, merge.merged_window_rows_reference(ordered, 31, G, 31 * ymax))


def _tie_slab(B, Dp, m, ymax, seed, dtype, device):
    """[B, Dp, m] rows drawn from {-1, -0.0, +0.0, 1} (+inf past ``ymax``):
    nearly every value ties."""
    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([-1.0, -0.0, 0.0, 1.0]), (B, Dp, m))
    x[:, :, ymax:] = np.inf
    return torch.as_tensor(np.ascontiguousarray(x[..., rng.permutation(m)]), dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("window", [5, 31])
def test_fold_and_merge_on_ties_and_signed_zeros(cuda, dtype, window):
    G, m, ymax = 20, 64, 50
    L = merge.n_levels(window)
    Dp = -(-(G - 1 + window) // 16) * 16
    ordered = merge.sort_rows_alternating(_tie_slab(3, Dp, m, ymax, seed=window, dtype=dtype, device=cuda))
    want = merge.merged_window_rows_reference(ordered, window, G, window * ymax)
    got = merge.merged_window_rows(ordered, window, G, ymax=ymax)
    torch.cuda.synchronize()
    assert _equal(got, want)
    if window >= 9:
        got = merge.fold_windows(ordered, merge.build_levels(ordered, L), window, G, ymax=ymax)
        torch.cuda.synchronize()
        assert _equal(got, want)


# ------------------------------------------------------------- windowed EQM


@pytest.mark.parametrize("window,calendar,nan", [(31, "noleap", False), (31, "standard", True), (5, "noleap", True)])
def test_public_windowed_eqm_on_cuda_matches_cpu(cuda, window, calendar, nan):
    """Windowed EQM on a few sites: through the merge kernels on the card,
    equal to the port's CPU merge path, and in float64 to the re-sort
    oracle."""
    t, data = heavy_problem(6, 5)
    if calendar != "noleap":
        t = xp.date_range("1950-01-01", periods=len(t), freq="D", calendar=calendar)
    if nan:
        data[0][0, 300:900] = np.nan
        data[1][2] = np.nan
    for key in merge.launches:
        merge.launches[key] = 0
    got = run_windowed_path(*(torch.from_numpy(a).to(cuda) for a in data), t, window)
    torch.cuda.synchronize()
    assert got.is_cuda and merge.launches["sort_rows_alternating"] >= 1
    assert merge.launches["fold_windows" if window >= 9 else "merged_window_rows"] >= 1
    with xp.set_options(selection_backend=False):  # the CPU's default engine is selection
        want = run_windowed_path(*(torch.from_numpy(a) for a in data), t, window)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-6, atol=2e-6, equal_nan=True)
    # against the re-sort oracle in float64: in float32 the merge engine's
    # unfused static arithmetic and the oracle's fused one differ in the
    # top tail as the reference's two paths do (ROADMAP C2)
    data64 = [torch.from_numpy(a).double() for a in data]
    got64 = run_windowed_path(*(a.to(cuda) for a in data64), t, window)
    torch.testing.assert_close(got64.cpu(), resort_oracle(*data64, t, window), rtol=1e-12, atol=1e-12, equal_nan=True)


# ------------------------------------------------------------ K7, K2


def _check_sort(key, lab):
    B, T = key.shape
    before = sort.launches
    got_k, got_l = sort.sort_rows_with_payload(key, lab)
    torch.cuda.synchronize()
    Tp = sort.padded_length(T)
    assert sort.launches == before + sort.launch_count(B, T)
    want_k, want_l = sort.sort_rows_with_payload_reference(key, lab)
    assert got_k.is_cuda and tuple(got_k.shape) == (B, Tp)
    assert _equal(got_k, want_k)
    gk, gl = pair_sorted(got_k, got_l)
    wk, wl = pair_sorted(want_k, want_l)
    assert _equal(gk, wk) and _equal(gl, wl)


@pytest.mark.parametrize("B,T", [
    (1, 1), (2, 128), (3, 1000), (2, 4097), (2, 8192), (4, 54750), (1, 1 << 20), (0, 300),
    (3, 16383), (3, 16384), (3, 16385), (1, 1 << 22),  # a tile less one, a tile, a tile and one; the longest row
])
def test_row_sort_with_payload_matches_twin(cuda, B, T):
    _check_sort(*sort_inputs(B, T, seed=T, device=cuda))


@pytest.mark.parametrize("case", ["all equal", "signed zeros and inf"])
@pytest.mark.parametrize("T", [1000, 54750])
def test_row_sort_with_payload_on_ties(cuda, case, T):
    rng = np.random.default_rng(T)
    if case == "all equal":
        key = np.full((3, T), 2.5, dtype=np.float32)
    else:
        key = rng.choice(np.array([-0.0, 0.0, np.inf], dtype=np.float32), (3, T))
    lab = rng.integers(0, 1 << 20, (3, T)).astype(np.int32)
    _check_sort(torch.from_numpy(key).to(cuda), torch.from_numpy(lab).to(cuda))


@pytest.mark.parametrize("R,L,nq", [(1, 1, 2), (7, 2049, 50), (5, 333, 64), (4, 100, 1), (512, 4650, 50)])
def test_row_lookup_matches_twin_bitwise(cuda, R, L, nq):
    v, xs, ys, nv = (a.reshape(R, -1).contiguous() for a in lookup_inputs(R, 1, L, nq, seed=R + L, device=cuda, extra=True))
    nv = nv.reshape(R)
    before = k.launches_2d
    got = k.interp_table_2d(v, xs, ys, nv)
    torch.cuda.synchronize()
    assert k.launches_2d == before + 1 and got.is_cuda and got.shape == v.shape
    assert _nan_equal(got, k.interp_table_2d_reference(v, xs, ys, nv))


def test_public_time_group_qdm_runs_k2(cuda):
    t, data = example_problem(8, 3)
    k.launches_2d = 0
    qdm = xp.QuantileDeltaMapping.train(*(xp.DataArray(a, ("site", "time"), {"time": t}, {"units": "K"}) for a in data[:2]), group="time", nquantiles=20)
    got = qdm.adjust(xp.DataArray(data[2], ("site", "time"), {"time": t}, {"units": "K"}), interp="linear").data
    torch.cuda.synchronize()
    assert got.is_cuda and k.launches_2d >= 1
    with xp.set_options(device="cpu"):
        want = xp.QuantileDeltaMapping.train(*(xp.DataArray(a, ("site", "time"), {"time": t}, {"units": "K"}) for a in data[:2]), group="time", nquantiles=20)
        want = want.adjust(xp.DataArray(data[2], ("site", "time"), {"time": t}, {"units": "K"}), interp="linear").data
    torch.testing.assert_close(got.cpu(), want, rtol=2e-6, atol=2e-6)


# ------------------------------------------------------------ selection engine


@pytest.mark.parametrize("sort_impl", ["pallas", "lax"])
@pytest.mark.parametrize("window", [5, 31])
def test_selection_engine_on_cuda_equals_cpu(cuda, sort_impl, window):
    t, data = heavy_problem(6, 5)
    x = torch.from_numpy(np.stack(nan_masked(data)[:2]).reshape(12, -1))
    plan = xp.Grouper("time.dayofyear", window=window).indexes(t).merge_plan
    q = equally_spaced_nodes(50).astype(np.float32)
    before = sort.launches
    got = selquant.selection_windowed_quantile(x.to(cuda), plan, q, sort_impl=sort_impl)
    torch.cuda.synchronize()
    assert got.is_cuda and (sort.launches > before) == (sort_impl == "pallas")
    assert _nan_equal(got.cpu(), selquant.selection_windowed_quantile(x, plan, q))


def test_public_selection_eqm_on_numpy_runs_on_the_card(cuda):
    """Numpy inputs, default device: the selection path (K7, K1, no merge
    kernel) on the card, equal to the port's CPU path and the oracle."""
    t, data = heavy_problem(6, 5)
    data = nan_masked(data)
    sort.launches = 0
    for key in merge.launches:
        merge.launches[key] = 0
    with xp.set_options(selection_on_tpu=True):
        got = run_windowed_path(*data, t)
    torch.cuda.synchronize()
    assert got.is_cuda and sort.launches >= 1 and not any(merge.launches.values())
    with xp.set_options(device="cpu"):
        want = run_windowed_path(*data, t)
    assert _nan_equal(got.cpu(), want)
    assert _nan_equal(got.cpu(), resort_oracle(*(torch.from_numpy(a) for a in data), t))


def test_object_from_file_adjusts_on_the_card(cuda, tmp_path):
    t, (ref, hist, sim) = heavy_problem(3, 4)
    mk = lambda x: xp.DataArray(x, ("site", "time"), {"time": t}, {"units": "K"})  # noqa: E731
    with xp.set_options(device="cpu"):
        trained = xp.EmpiricalQuantileMapping.train(mk(ref), mk(hist), group="time.dayofyear", window=31, nquantiles=20)
        want = trained.adjust(mk(sim), interp="linear").data
    path = str(tmp_path / "eqm")
    trained.save(path)
    got = xp.EmpiricalQuantileMapping.from_file(path).adjust(mk(sim), interp="linear").data
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), want, rtol=2e-6, atol=2e-6)


# ------------------------------------------------ bracketed lookup, fma


def _random_brackets(T, Gp, seed):
    """[T] brackets over Gp groups with w = 0 and 1 and g0 == g1 among them."""
    rng = np.random.default_rng(seed)
    g0 = rng.integers(0, Gp, T)
    g1 = np.where(rng.random(T) < 0.2, g0, rng.integers(0, Gp, T))
    w = rng.random(T)
    w[::5], w[1::5] = 0.0, 1.0
    return g0, g1, w


@pytest.mark.parametrize("B,T,Gp,nq", [
    (1, 1, 3, 2),
    (3, 1001, 3, 7),       # Gp = 3 (one group, padded), an odd length
    (5, 8192, 14, 50),     # one full tile
    (4, 8193, 14, 50),     # a tile and one value
    (6, 54750, 14, 50),    # the headline's row: odd sites start 8 bytes off
    (3, 3000, 14, 64),
    (2, 777, 14, 1),
    (2, 5000, 46, 50),     # the most tables the kernel takes
    (2, 5000, 46, 64),
])
def test_bracketed_kernel_matches_twin_bitwise(cuda, B, T, Gp, nq):
    args = bracket_inputs(B, Gp, nq, *_random_brackets(T, Gp, seed=T + Gp), seed=B + T, device=cuda, extra=True)
    before = k.launches_bracketed
    got = k.interp_bracketed(*args)
    torch.cuda.synchronize()
    assert k.launches_bracketed == before + 1 and got.is_cuda and tuple(got.shape) == (B, T)
    assert _nan_equal(got, k.interp_bracketed_reference(*args))


def test_bracketed_kernel_on_monthly_brackets_and_an_unfitted_site(cuda):
    """The calendar's brackets; site 1 has no fitted table at all (NaN
    everywhere), site 2 one unfitted month."""
    t, _ = example_problem(1, 7)
    b = xp.Grouper("time.month").indexes(t).bracket_partitions("linear")
    v, xs, ys, nv, g0, g1, w = bracket_inputs(4, 14, 50, b["g0"], b["g1"], b["w"], seed=3, device=cuda, extra=True)
    xs[1], ys[1], nv[1] = torch.inf, torch.nan, 0
    xs[2, 5], ys[2, 5], nv[2, 5] = torch.inf, torch.nan, 0
    g0[3], g1[4] = 14, -1   # ids outside [0, Gp) have no table: NaN, and no read outside the tables
    got = k.interp_bracketed(v, xs, ys, nv, g0, g1, w)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[1]).all()) and not bool(torch.isnan(got[0]).all()) and bool(torch.isnan(got[:, 3:5]).all())
    assert _nan_equal(got, k.interp_bracketed_reference(v, xs, ys, nv, g0, g1, w))


def test_bracketed_kernel_on_values_off_16_bytes(cuda):
    args = bracket_inputs(3, 14, 50, *_random_brackets(4001, 14, seed=5), seed=6, device=cuda)
    v = args[0]
    off = torch.cat([v.new_zeros(1), v.reshape(-1)])[1:].reshape(v.shape)
    assert off.data_ptr() % 16 == 4
    got = k.interp_bracketed(off, *args[1:])
    torch.cuda.synchronize()
    assert _nan_equal(got, k.interp_bracketed_reference(*args))


@pytest.mark.parametrize("G,route", [(12, "bracketed"), (44, "bracketed"), (45, "partition")])
def test_grouped_lookup_route_on_the_card(cuda, G, route):
    """``interp_grouped_partitioned`` on CUDA tensors: blended brackets whose
    G + 2 padded tables fit shared memory take one bracketed launch and no
    K1; one table more and it takes the partition route through K1, twice.
    Both equal the CPU path bit for bit."""
    rng = np.random.default_rng(G)
    T, nq = 3000, 50
    pos = np.sort(rng.random(T)) * G
    g0 = np.clip(np.floor(pos).astype(np.int64), 0, G - 1)
    brackets = dict(g0=g0 + 1, g1=g0 + 2, w=pos - g0)
    parts = {}
    for side in ("0", "1"):
        grp = brackets["g" + side]
        counts = np.bincount(grp, minlength=G + 2)
        part = np.full((G + 2, counts.max()), -1, np.int64)
        slot = np.zeros(T, np.int64)
        for g in range(G + 2):
            at = np.nonzero(grp == g)[0]
            part[g, : len(at)] = at
            slot[at] = np.arange(len(at))
        parts[side] = (part, grp, slot)
    xq = np.sort(rng.normal(0, 1, (3, G, nq)), axis=-1).astype(np.float32)
    yq = rng.normal(0, 1, (3, G, nq)).astype(np.float32)
    v = rng.normal(0, 1.5, (3, T)).astype(np.float32)
    call = lambda dev: interp.interp_grouped_partitioned(  # noqa: E731
        *(torch.from_numpy(a).to(dev) for a in (v, xq, yq)), *parts["0"], *parts["1"], brackets["w"], "linear", "constant", tables_compact=True)
    assert interp.lookup_route("cuda", torch.float32, nq, G + 2, True, "linear", "constant") == route
    k.launches = k.launches_bracketed = 0
    got = call(cuda)
    torch.cuda.synchronize()
    assert (k.launches_bracketed, k.launches) == ((1, 0) if route == "bracketed" else (0, 2))
    assert _nan_equal(got.cpu(), call("cpu"))


def test_grouped_lookup_takes_the_brackets_steps_as_they_are(cuda):
    """With ``Brackets.steps`` on the card the bracketed route converts
    nothing and gives the CPU path's bits; steps on another device are
    converted, not passed on."""
    from xsdba_tpu_torch.models._wrap import device_brackets

    t, (_, hist, sim) = example_problem(3, 2)
    gi = xp.Grouper("time.month").indexes(t)
    rng = np.random.default_rng(3)
    xq = np.sort(rng.normal(13, 3, (3, 12, 50)), axis=-1).astype(np.float32)
    yq = rng.normal(0, 1, (3, 12, 50)).astype(np.float32)
    call = lambda dev, br: interp.interp_grouped_partitioned(  # noqa: E731
        *(torch.from_numpy(a).to(dev) for a in (sim, xq, yq)), *br, "linear", "constant", tables_compact=True, steps=br.steps)
    want = call("cpu", device_brackets(gi, "linear"))
    for br in (device_brackets(gi, "linear", cuda), device_brackets(gi, "linear")):
        k.launches = k.launches_bracketed = 0
        got = call(cuda, br)
        torch.cuda.synchronize()
        assert (k.launches_bracketed, k.launches) == (1, 0)
        assert _nan_equal(got.cpu(), want)


def test_bracketed_wrapper_raises_over_its_budget(cuda):
    args = bracket_inputs(2, 47, 50, *_random_brackets(100, 47, seed=1), seed=2, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        k.interp_bracketed(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["same shape", "broadcast", "transposed", "scalars", "off 16 bytes", "short"])
def test_fma_kernel_matches_emulation_bitwise(cuda, dtype, case):
    a, b, c = fma_inputs(200_003, dtype, seed=len(case), device=cuda)
    if case == "broadcast":      # the static extraction's lerp: [rows, G, nq] against [G, nq], and a column
        a, b, c = a[:200_000].reshape(50, 80, 50), b[:4000].reshape(80, 50), c[:50].reshape(50, 1, 1)
    elif case == "transposed":
        a, b, c = a[:200_000].reshape(400, 500).T, b[:200_000].reshape(500, 400), c[:500].reshape(500, 1)
    elif case == "scalars":      # the virtual index's offset: 0-dim operands
        b, c = b[7].reshape(()), c[9].reshape(())
    elif case == "off 16 bytes":
        a, b, c = a[1:], b[1:], c[1:]
    elif case == "short":
        a, b, c = a[:3], b[:3], c[:3]
    before = fma_kernel.launches
    got = fma(a, b, c)
    torch.cuda.synchronize()
    assert fma_kernel.launches == before + 1 and got.is_cuda and got.dtype == dtype
    assert got.shape == torch.broadcast_shapes(a.shape, b.shape, c.shape)
    assert _nan_equal(got, fma_kernel.fma_reference(a, b, c))


def test_fma_kernel_rejects_mixed_operands(cuda):
    a, b, c = fma_inputs(10, torch.float32, device=cuda)
    with pytest.raises(TypeError):
        fma(a, b.double(), c)
    with pytest.raises(ValueError):
        fma(a, b.cpu(), c)


# ------------------------------------- the nearest method and the multivariate path


@pytest.mark.parametrize("B,Gp,Lp,nq", [
    (1, 3, 1, 2), (2, 14, 2049, 50), (4, 7, 333, 64), (3, 5, 100, 1), (5, 4, 3, 2), (16, 367, 150, 50),
    (3, 5, 1023, 50), (3, 5, 1024, 50), (3, 5, 1025, 1), (2, 3, 4097, 17), (6, 31, 930, 20),
])
def test_nearest_kernel_matches_twin_bitwise(cuda, B, Gp, Lp, nq):
    """The lookup kernel's nearest method on K1's and K2's entries: on-node
    values, ties, one- and two-node and empty tables, +-inf and NaN."""
    v, xs, ys, nv = lookup_inputs(B, Gp, Lp, nq, seed=B + Lp, device=cuda, extra=True)
    k.launches = k.launches_2d = 0
    got = k.interp_table_3d(v, xs, ys, nv, "nearest")
    rows = tuple(a.reshape((B * Gp,) + a.shape[2:]) for a in (v, xs, ys, nv))
    got2 = k.interp_table_2d(*rows, "nearest")
    torch.cuda.synchronize()
    assert (k.launches, k.launches_2d) == (1, 1)
    want = k.interp_table_3d_reference(v, xs, ys, nv, "nearest")
    assert _nan_equal(got, want) and _nan_equal(got2.reshape(got.shape), want)
    if nq > 1 and Lp > 100:
        assert not _nan_equal(got, k.interp_table_3d(v, xs, ys, nv))     # not the linear answer


@pytest.mark.parametrize("R,L,nq", [(192, 10950, 50), (4000, 930, 20), (3, 1, 1)])
def test_nearest_kernel_on_rank_like_values(cuda, R, L, nq):
    """Ranks in [0, 1] with exact zeros, ones and ties half way between two
    nodes, at the multivariate schemes' row lengths."""
    from chip_smoke import rank_lookup_inputs

    args = rank_lookup_inputs(R, L, nq, seed=L, device=cuda)
    got = k.interp_table_2d(*args, "nearest")
    torch.cuda.synchronize()
    assert _nan_equal(got, k.interp_table_2d_reference(*args, "nearest"))
    off = torch.cat([args[0].new_zeros(1), args[0].reshape(-1)])[1:].reshape(args[0].shape)
    assert _nan_equal(k.interp_table_2d(off, *args[1:], "nearest"), got)


def test_kernel_rejects_an_unknown_method(cuda):
    v, xs, ys, nv = lookup_inputs(1, 3, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="methods"):
        k.interp_table_3d(v, xs, ys, nv, "cubic")


def _mv(n_sites, seed, years=3, start="1981-01-01"):
    T = 365 * years
    t = xp.date_range(start, periods=T, freq="D", calendar="noleap")
    x = np.random.default_rng(seed).normal(10, 3, (n_sites, 3, T)).astype(np.float32)
    x[:, 1] += 0.5 * x[:, 0]
    return xp.DataArray(x, ("site", "multivar", "time"), {"time": t, "multivar": np.array(["a", "b", "c"]), "site": np.arange(n_sites)}, {"units": ""}, "data")


@pytest.mark.parametrize("group,n_chunks", [(("time", 1), 1), (("time.dayofyear", 5), 3)])
def test_mbcn_on_the_card_against_the_cpu_port(cuda, monkeypatch, group, n_chunks):
    """Numpy-fed MBCn trains and adjusts on the card through K2's nearest
    method (``n_iter`` launches a chunk by train, ``n_iter + V`` by adjust)
    and agrees with the CPU port given the same rotations: three float32
    iterations, ``af_q`` at 5e-5."""
    from xsdba_tpu_torch.models import mbcn

    ref, hist, sim = _mv(4, 1), _mv(4, 2), _mv(4, 3, start="2011-01-01")
    if n_chunks > 1:
        monkeypatch.setattr(mbcn, "_TRAIN_CHUNK_BUDGET", 4 * 3 * 15 * 130)       # 130 of 365 blocks a chunk
    kw = dict(base_kws={"nquantiles": 10, "group": xp.Grouper(*group)}, n_iter=3, n_escore=20)
    k.launches = k.launches_2d = k.launches_bracketed = 0
    obj = xp.MBCn.train(ref, hist, **kw)
    assert obj.ds["af_q"].data.is_cuda and obj.ds["rot_matrices"].data.is_cuda
    assert k.launches_2d == n_chunks * 3
    scen = obj.adjust(sim, ref, hist)
    torch.cuda.synchronize()
    assert (k.launches_2d, k.launches, k.launches_bracketed) == (n_chunks * (3 + 3 + 3), 0, 0)
    assert scen.data.is_cuda and scen.dims == sim.dims and bool(torch.isfinite(scen.data).all())
    with xp.set_options(device="cpu"):
        cpu = xp.MBCn.train(ref, hist, rot_matrices=obj.ds["rot_matrices"].data.cpu(), **kw)
        cpu_scen = cpu.adjust(sim, ref, hist)
    torch.testing.assert_close(obj.ds["af_q"].data.cpu(), cpu.ds["af_q"].data, rtol=0, atol=5e-5)
    torch.testing.assert_close(obj.ds["escores"].data.cpu(), cpu.ds["escores"].data, rtol=2e-3, atol=1e-5)
    assert float((scen.data.cpu() != cpu_scen.data).float().mean()) <= 0.01


def test_npdf_transform_scaling_and_loci_on_the_card(cuda):
    """Numpy-fed NpdfTransform (monthly QDM base: K1's nearest method),
    Scaling and LOCI run on the card and agree with the CPU port."""
    from xsdba_tpu_torch.ops.rotation import rand_rot_matrix

    ref, hist, sim = _mv(3, 4), _mv(3, 5), _mv(3, 6, start="2011-01-01")
    rot = rand_rot_matrix(3, num=3, device=cuda)
    assert rot.is_cuda
    kw = dict(base_kws={"nquantiles": 10, "group": "time.month"}, n_iter=3, n_escore=0)
    k.launches = 0
    with xp.set_options(extra_output=True):
        out = xp.NpdfTransform.adjust(ref, hist, sim, rot_matrices=rot, **kw)
        with xp.set_options(device="cpu"):
            cpu = xp.NpdfTransform.adjust(ref, hist, sim, rot_matrices=rot.cpu(), **kw)
    assert k.launches == 6 and out["scen"].data.is_cuda
    assert float(((out["scen"].data.cpu() - cpu["scen"].data).abs() > 1e-4).float().mean()) <= 0.01
    torch.testing.assert_close(out["escores"].data.cpu(), cpu["escores"].data, rtol=5e-3, atol=1e-4)

    t = xp.date_range("1981-01-01", periods=365 * 3, freq="D", calendar="noleap")
    rng = np.random.default_rng(7)
    r, h, s = (xp.DataArray(rng.gamma(2, 2, (4, len(t))).astype(np.float32), ("site", "time"), {"time": t}, {"units": "mm/d"}, "pr") for _ in range(3))
    for cls, tkw, tol in (("Scaling", dict(kind="*"), 2e-6), ("LOCI", dict(thresh="1 mm/d"), 2e-5)):
        before = fma_kernel.launches
        got = getattr(xp, cls).train(r, h, group="time.month", **tkw).adjust(s, interp="linear").data
        assert got.is_cuda and fma_kernel.launches > before
        with xp.set_options(device="cpu"):
            want = getattr(xp, cls).train(r, h, group="time.month", **tkw).adjust(s, interp="linear").data
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


# ------------------------------------------------------------------ DQM


@pytest.mark.parametrize("path", ["config 2", "dayofyear+31"])
def test_public_dqm_on_the_card_against_the_cpu_port(cuda, path):
    """Config 2 (pr, adapt_freq, jitter, LOESS, nearest on the monthly
    partition's long rows) and the windowed DQM (merge engine, polynomial
    trend) at 8 sites x 10 years on numpy inputs: one K1 launch on config 2's
    path and no merge kernel, the merge kernels on the other's; against the
    CPU port on the same draws, the trend at 1e-5 and scen but for rank
    flips of the nearest lookup."""
    if path == "config 2":
        t, (ref, hist, sim) = pr_problem(8, 10)
        train, adjust, cpu_opts = config2_train, config2_adjust, dict(device="cpu")
    else:
        t, (ref, hist, sim) = heavy_problem(8, 10)
        train, adjust, cpu_opts = dqm_doy_train, dqm_doy_adjust, dict(device="cpu", selection_backend=False)
    k.launches = 0
    for key in merge.launches:
        merge.launches[key] = 0
    with SeededDraws(3):
        got = adjust(train(ref, hist, t), sim, t)
    torch.cuda.synchronize()
    assert got["scen"].data.is_cuda and bool(torch.isfinite(got["scen"].data).all())
    assert k.launches == 1
    assert (merge.launches["fold_windows"] == 0) if path == "config 2" else (merge.launches["fold_windows"] >= 1)
    with SeededDraws(3), xp.set_options(**cpu_opts):
        want = adjust(train(ref, hist, t), sim, t)
    torch.testing.assert_close(got["trend"].data.cpu(), want["trend"].data, rtol=LOESS_RTOL, atol=LOESS_RTOL)
    held_with_flips(path, got["scen"].data.cpu(), want["scen"].data)


@pytest.mark.parametrize("n,d", [(300, 0), (300, 1), (20000, 0), (20000, 1)])
@pytest.mark.parametrize("niter", [1, 2])
def test_loess_on_the_card_against_the_cpu(cuda, n, d, niter):
    """Both LOESS cores (gathered windows at n = 300, FFT interior and edge
    products at n = 20000) on the card against the CPU, float64 at 1e-12
    and float32 at FLIP_RTOL (d = 0)."""
    rng = np.random.default_rng(n + d)
    y = rng.gamma(2.0, 2.0, (4, n)) + 0.5
    y[0, 7] = np.nan
    x = np.arange(n, dtype=np.float64)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, FLIP_RTOL if d == 0 else 1e-3)):
        yt = torch.from_numpy(y).to(dtype)
        got = loess_smoothing(yt.to(cuda), x, f=0.2, niter=niter, d=d).cpu()
        want = loess_smoothing(yt, x, f=0.2, niter=niter, d=d)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol, equal_nan=True)


# ------------------------------------------------- second-order transforms


def test_extremes_on_the_card_against_the_cpu_port(cuda):
    """ExtremeValues on config 2's recipe at 4 sites x 20 years, numpy
    inputs: the fma kernel launched and nothing else, outputs on the card,
    the threshold equal to the CPU port's at EV_THRESH_RTOL and the other
    outputs within the fit's precision (ROADMAP C18)."""
    from chip_smoke import EV_FIT_TOL, EV_RTOL, EV_THRESH_RTOL, extremes_run

    t, (ref, hist, sim) = pr_problem(4, 20)
    scen = 0.9 * sim
    fma_kernel.launches = k.launches = k.launches_2d = 0
    ev, out = extremes_run(ref, hist, sim, scen, t)
    torch.cuda.synchronize()
    assert fma_kernel.launches >= 1 and k.launches == k.launches_2d == 0
    assert out.data.is_cuda and ev.ds["af"].data.is_cuda and bool(torch.isfinite(out.data).all())
    with xp.set_options(device="cpu"):
        ev_cpu, out_cpu = extremes_run(ref, hist, sim, scen, t)
    torch.testing.assert_close(ev.ds["thresh"].data.cpu(), ev_cpu.ds["thresh"].data, rtol=EV_THRESH_RTOL, atol=0)
    torch.testing.assert_close(ev.ds["ref_params"].data[:, 0].cpu(), ev_cpu.ds["ref_params"].data[:, 0], rtol=0, atol=EV_FIT_TOL)
    torch.testing.assert_close(out.data.cpu(), out_cpu.data, rtol=EV_RTOL, atol=EV_RTOL)


@pytest.mark.parametrize("orientation", ["simple", "full"])
def test_pca_on_the_card_against_the_cpu_port(cuda, orientation):
    from chip_smoke import PCA_RTOL, mbcn_problem, pca_run

    ref, hist, sim = mbcn_problem(4)
    pca, scen = pca_run(ref, hist, sim, orientation)
    assert scen.data.is_cuda and pca.ds["trans"].data.is_cuda and scen.dims == sim.dims
    with xp.set_options(device="cpu"):
        pca_cpu, scen_cpu = pca_run(ref, hist, sim, orientation)
    torch.testing.assert_close(pca.ds["trans"].data.cpu(), pca_cpu.ds["trans"].data, rtol=PCA_RTOL, atol=PCA_RTOL)
    torch.testing.assert_close(scen.data.cpu(), scen_cpu.data, rtol=PCA_RTOL, atol=PCA_RTOL)


def test_sinkhorn_and_otc_on_the_card(cuda):
    """The Sinkhorn plan on the card equals the CPU's at 1e-12 (float64);
    OTC's result comes back on the card and equals the CPU port's given the
    same draws (the plans are host work)."""
    from chip_smoke import ot_problem, ot_run
    from xsdba_tpu_torch.ops.ot import sinkhorn_plan

    rng = np.random.default_rng(8)
    mu, nu = rng.random(40), rng.random(50)
    x, y = rng.normal(0, 1, (40, 2)), rng.normal(0.3, 1, (50, 2))
    C = torch.from_numpy(((x[:, None] - y[None]) ** 2).sum(-1))
    got = sinkhorn_plan(mu / mu.sum(), nu / nu.sum(), C.to(cuda))
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), sinkhorn_plan(mu / mu.sum(), nu / nu.sum(), C), rtol=0, atol=1e-12)
    ref, hist, sim = ot_problem(3)
    out = ot_run("dOTC kind pr *", ref, hist, sim)
    assert out.data.is_cuda
    with xp.set_options(device="cpu"):
        want = ot_run("dOTC kind pr *", ref, hist, sim)
    assert torch.equal(out.data.cpu(), want.data)


# ----------------------------------------------------------------- diagnostics


def test_gev_fit_ml_on_the_card(cuda):
    """float64 fits on the card against the CPU path: the same likelihood
    reached to 1e-10 relative, the return values at 1e-6 (the Newton steps'
    last decisions follow rounding noise near a flat optimum, ROADMAP C20);
    float32 return values at 1e-3."""
    from scipy import stats

    from xsdba_tpu_torch.ops.fitting import _gev_nll, gev_fit_ml, gev_ppf

    x = stats.genextreme.rvs(0.12, loc=30, scale=3, size=(64, 150), random_state=1)
    x[3] = np.nan
    x[5, 2:] = np.nan
    for dtype, rtol in ((torch.float64, 1e-6), (torch.float32, 1e-3)):
        t = torch.from_numpy(x).to(dtype)
        got = gev_fit_ml(t.to(cuda))
        want = gev_fit_ml(t)
        assert all(a.is_cuda and a.dtype == dtype for a in got)
        got = [a.cpu() for a in got]
        torch.testing.assert_close(gev_ppf(0.95, *got), gev_ppf(0.95, *want), rtol=rtol, atol=0, equal_nan=True)
        if dtype == torch.float64:
            valid = ~torch.isnan(t)
            nll = [_gev_nll(torch.stack([p[0], p[1], torch.log(p[2])], -1), t, valid) for p in (got, want)]
            ok = torch.isfinite(nll[1])
            torch.testing.assert_close(nll[0][ok], nll[1][ok], rtol=1e-10, atol=0)


def test_betainc_on_the_card(cuda):
    """The card against the CPU path on the grid of ``test_torch_fitting.py``:
    float64 at 1e-12; float32 at 2e-4 absolute, the continued fraction's
    float32 rounding (the log-beta factor), as held against the reference."""
    from xsdba_tpu_torch.ops.fitting import betainc

    df = torch.arange(1, 301, dtype=torch.float64)[:, None].expand(300, 97)
    x = torch.linspace(0.001, 0.999, 97, dtype=torch.float64)[None].expand(300, 97)
    for dtype, rtol, atol in ((torch.float64, 1e-12, 1e-12), (torch.float32, 0.0, 2e-4)):
        a, b, xx = (v.to(dtype) for v in (df / 2, torch.full_like(df, 0.5), x))
        got = betainc(a.to(cuda), b.to(cuda), xx.to(cuda))
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), betainc(a, b, xx), rtol=rtol, atol=atol)


def test_run_lengths_on_the_card(cuda):
    from xsdba_tpu_torch.properties import _run_lengths

    cond = torch.from_numpy(np.random.default_rng(2).random((64, 150, 365)) < 0.6)
    cond[0, 0] = True
    got = _run_lengths(cond.to(cuda))
    assert got.is_cuda
    assert torch.equal(got.cpu(), _run_lengths(cond))


def test_pairwise_spearman_on_the_card(cuda):
    """A plain product of ranks, in full float32 on the card (TF32 off)."""
    from xsdba_tpu_torch.properties import _pairwise_spearman

    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 2000)) + rng.normal(size=2000)[None]
    x[4, :100] = np.nan
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        t = torch.from_numpy(x).to(dtype)
        got = _pairwise_spearman(t.to(cuda))
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), _pairwise_spearman(t), rtol=tol, atol=tol)


def test_properties_stay_on_the_input_device(cuda):
    """Every property and measure of config 5's suite, and the spatial
    ones, return their values on the card for card data, equal to the CPU
    path's at 1e-5 (float32; the return value's fit at 1e-3).  150 years:
    with a few tens of annual maxima the float32 likelihood is so flat that
    rounding alone moves the return value by ~1e-3 (ROADMAP C20)."""
    from chip_smoke import config5_block, config5_coords, config5_return_values, config5_suite
    from xsdba_tpu_torch import measures, properties

    t, tas_np, pr_np = config5_block(0, 16, 150)
    coords = config5_coords(0, 16)
    das = lambda arrays, units, dev: {k: xp.DataArray(torch.from_numpy(a).to(dev), ("site", "time"), {"time": t, **coords}, {"units": units}, "v")  # noqa: E731
                                      for k, a in zip(("ref", "sim", "scen"), arrays)}
    got, want = ((lambda tas, pr: config5_suite(properties, measures, tas, pr) | config5_return_values(properties, measures, tas))(das(tas_np, "K", dev), das(pr_np, "mm/d", dev))
                 for dev in (cuda, torch.device("cpu")))
    for key, da in got.items():
        assert da.data.is_cuda, key
        torch.testing.assert_close(da.data.cpu(), want[key].data, rtol=1e-3 if "rv20" in key else 1e-5, atol=1e-5, msg=key)
    tile = das(tas_np, "K", cuda)["scen"]
    for fn in (properties.spatial_correlogram, properties.decorrelation_length, properties.first_eof):
        assert fn(tile).data.is_cuda, fn
    assert measures.scorr(tile, das(tas_np, "K", cuda)["ref"]).data.is_cuda


# ---------------------------------------------------- cubic, periods, filters


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cubic_lookup_on_the_card_equals_the_cpu_port(cuda, dtype):
    """The cubic lookup on CUDA tensors (every fused product through the
    ``fma`` kernel) against the CPU port (the exact emulation): equal under
    ==, also on short, empty and duplicated-node tables."""
    rng = np.random.default_rng(21)
    B, nq = 64, 50
    xq = np.sort(rng.normal(0, 3, (B, nq)), axis=-1)
    yq = rng.normal(0, 1, (B, nq))
    xq[1, 10:14] = np.nan
    xq[2, 3:] = np.nan
    xq[3] = np.nan
    xq[4, 7] = xq[4, 6]
    v = rng.normal(0, 4, (B, 3000))
    v[:, :5] = xq[:, :5]
    v[:, 9] = np.nan
    args = [torch.as_tensor(a, dtype=dtype) for a in (v, xq, yq)]
    want = interp.interp1d_table(*args, "cubic", "constant")
    launched = fma_kernel.launches
    got = interp.interp1d_table(*(a.to(cuda) for a in args), "cubic", "constant")
    assert got.is_cuda and fma_kernel.launches > launched
    assert _nan_equal(got.cpu(), want)


@pytest.mark.parametrize("cls,group", [("QuantileDeltaMapping", "time.month"), ("EmpiricalQuantileMapping", ("time.dayofyear", 31)), ("DetrendedQuantileMapping", "time")])
def test_public_cubic_on_the_card_against_the_cpu_port(cuda, cls, group):
    t, (ref, hist, sim) = example_problem(8, 6)
    g = lambda: xp.Grouper(*group) if isinstance(group, tuple) else group  # noqa: E731
    da = lambda x, name: xp.DataArray(x, ("site", "time"), {"time": t}, {"units": "K"}, name)  # noqa: E731
    k.launches = k.launches_2d = k.launches_bracketed = 0
    got = getattr(xp, cls).train(da(ref, "ref"), da(hist, "hist"), group=g(), nquantiles=20).adjust(da(sim, "sim"), interp="cubic").data
    assert got.is_cuda and k.launches == k.launches_2d == k.launches_bracketed == 0
    with xp.set_options(device="cpu", selection_backend=False):
        want = getattr(xp, cls).train(da(ref, "ref"), da(hist, "hist"), group=g(), nquantiles=20).adjust(da(sim, "sim"), interp="cubic").data
    torch.testing.assert_close(got.cpu(), want, rtol=2e-6, atol=2e-6)


def test_spectral_filter_on_the_card(cuda):
    """The DCT filter by ``torch.fft`` on the card against the CPU port:
    2e-6 of the field's scale (cuFFT rounds in its own order)."""
    rng = np.random.default_rng(22)
    x = (280 + rng.normal(0, 2, (40, 24, 32))).astype(np.float32)
    t = xp.date_range("2000-01-01", periods=40, freq="D", calendar="noleap")
    da = lambda data: xp.DataArray(data, ("time", "lat", "lon"), {"time": t, "lat": 45 + 0.25 * np.arange(24), "lon": 0.25 * np.arange(32)}, {"units": "K"}, "tas")  # noqa: E731
    kw = dict(dims=["lat", "lon"], lam_long="400 km", lam_short="100 km")
    got = xp.processing.spectral_filter(da(torch.from_numpy(x).to(cuda)), **kw).data
    want = xp.processing.spectral_filter(da(torch.from_numpy(x)), **kw).data
    assert got.is_cuda and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-6 * float(want.abs().max()))


def test_stack_adjust_unstack_on_the_card(cuda):
    """The moving-window adjustment on the card: ``stack_periods`` (a copy
    on the data's device), QDM's adjust of the stack (the period dim first:
    the trained tables broadcast against sim's leading dims by position),
    ``unstack_periods``; against the CPU port at 2e-6, and the round trip
    of the stack alone under ==."""
    t, (ref, hist, sim) = example_problem(4, 50)
    t30 = xp.date_range("2000-01-01", periods=365 * 30, freq="D", calendar="noleap")
    da = lambda x, tt, name: xp.DataArray(x, ("site", "time"), {"time": tt}, {"units": "K"}, name)  # noqa: E731

    def run():
        qdm = xp.QuantileDeltaMapping.train(da(ref[:, : 365 * 30], t30, "ref"), da(hist[:, : 365 * 30], t30, "hist"), group="time.month", nquantiles=20)
        stacked = xp.processing.stack_periods(da(sim, t, "sim"), window=30, stride=10)
        return stacked, xp.processing.unstack_periods(qdm.adjust(stacked.transpose("period", "site", "time"))).data

    stacked, got = run()
    assert stacked.data.is_cuda and tuple(stacked.shape) == (4, 3, 365 * 30) and got.is_cuda
    assert torch.equal(xp.processing.unstack_periods(stacked).data.cpu(), torch.from_numpy(sim))
    with xp.set_options(device="cpu"):
        _, want = run()
    torch.testing.assert_close(got.cpu(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nbutils_on_the_card_equals_the_cpu_port(cuda, dtype):
    """Numpy data goes to the card; the unfused type-7 arithmetic is one
    kernel an operation there, so the card equals the CPU port under ==."""
    from xsdba_tpu_torch import nbutils

    t, (_, _, sim) = example_problem(16, 3)
    sim = sim.astype(dtype)
    sim[3, ::7] = np.nan
    sim[5] = np.nan
    da = xp.DataArray(sim, ("site", "time"), {"time": t}, {"units": "K"}, "sim")
    q = equally_spaced_nodes(50)
    ranks = np.random.default_rng(0).random(16).astype(dtype)
    got = [nbutils.quantile(da, q, "time").data, nbutils.vecquantiles(da, ranks, "time").data, nbutils.quantile(sim, q, 1)]
    with xp.set_options(device="cpu"):
        want = [nbutils.quantile(da, q, "time").data, nbutils.vecquantiles(da, ranks, "time").data, nbutils.quantile(sim, q, 1)]
    for g, w in zip(got, want):
        assert g.is_cuda
        assert _nan_equal(g.cpu(), w)


def test_profiling_on_the_card(cuda, tmp_path):
    """``trace`` names the card's kernels in its file and refuses a capture
    with no CUDA activity; ``timed`` synchronises on the output's device."""
    import json

    from xsdba_tpu_torch.utils import profiling

    x = torch.rand(64, 4096, device=cuda)
    with profiling.trace(str(tmp_path / "t")):
        torch.sort(x, dim=-1)
    (f,) = (tmp_path / "t").iterdir()
    assert any(e.get("cat") == "kernel" for e in json.loads(f.read_text())["traceEvents"])
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        with profiling.trace(str(tmp_path / "u")):
            torch.ones(3).sum()
    assert not (tmp_path / "u").exists()
    best, out = profiling.timed(lambda: torch.sort(x, dim=-1).values, reps=3)
    assert best > 0 and out.is_cuda


def test_selftest_on_the_card(cuda, capsys):
    from xsdba_tpu_torch import cli

    assert cli.main(["selftest"]) == 0
    assert "selftest on cuda" in capsys.readouterr().out
    bias, device = cli._selftest_run()
    with xp.set_options(device="cpu"):
        bias_cpu, _ = cli._selftest_run()
    assert device.type == "cuda" and abs(bias - bias_cpu) <= 1e-6
