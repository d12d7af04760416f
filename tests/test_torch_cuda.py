"""The port on an NVIDIA GPU: the CUDA kernels against their plain twins,
and the public QDM and windowed EQM paths on CUDA tensors against the port's
CPU path.

Every test here needs a card (and ``nvcc`` to build the kernels) and skips
without one.  The file imports no JAX, so it also runs where JAX is absent;
there, bypass ``tests/conftest.py`` (which imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

import xsdba_tpu_torch as xp
from chip_smoke import example_problem, heavy_problem, lookup_inputs, resort_oracle, run_main_path, run_windowed_path
from xsdba_tpu_torch.ops import merge
from xsdba_tpu_torch.ops.cuda import interp_kernel as k

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
])
def test_kernel_matches_twin_bitwise(cuda, B, Gp, Lp, nq):
    v, xs, ys, nv = lookup_inputs(B, Gp, Lp, nq, seed=B + Lp, device=cuda)
    before = k.launches
    got = k.interp_table_3d(v, xs, ys, nv)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert got.is_cuda and got.dtype == torch.float32 and got.shape == v.shape
    assert _nan_equal(got, k.interp_table_3d_reference(v, xs, ys, nv))


def test_kernel_rejects_tables_on_another_device(cuda):
    v, xs, ys, nv = lookup_inputs(1, 3, 8, 4, device=cuda)
    with pytest.raises(ValueError):
        k.interp_table_3d(v, xs.cpu(), ys, nv)


def test_public_qdm_on_cuda_matches_cpu(cuda):
    t, data = example_problem(16, 4)
    k.launches = 0
    got = run_main_path(*(torch.from_numpy(a).to(cuda) for a in data), t)
    torch.cuda.synchronize()
    assert k.launches == 2 and got.is_cuda and bool(torch.isfinite(got).all())
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,Dp,m", [(1, 2, 1), (3, 8, 2), (4, 64, 16), (2, 400, 256), (1, 6, 2048)])
def test_row_sort_matches_twin(cuda, dtype, B, Dp, m):
    x = _slab(B, Dp, m, max(m - 3, 1), seed=m, dtype=dtype, device=cuda)
    before = merge.launches["sort_rows_alternating"]
    got = merge.sort_rows_alternating(x)
    torch.cuda.synchronize()
    assert merge.launches["sort_rows_alternating"] == before + 1 and got.is_cuda
    assert _equal(got, merge.sort_rows_alternating_reference(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("window,m,ymax", [(9, 16, 11), (24, 16, 16), (31, 256, 150), (31, 8, 5)])
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


@pytest.mark.parametrize("window", [1, 3, 5, 8])
def test_per_group_merge_matches_twin(cuda, window):
    G, m, ymax = 30, 32, 20
    ordered = merge.sort_rows_alternating(_slab(4, 40, m, ymax, seed=window, device=cuda))
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


# ------------------------------------------------------------- windowed EQM


@pytest.mark.parametrize("window,calendar,nan", [(31, "noleap", False), (31, "standard", True), (5, "noleap", True)])
def test_public_windowed_eqm_on_cuda_matches_cpu(cuda, window, calendar, nan):
    """Windowed EQM on a few sites: through the kernels on the card, equal
    to the port's CPU path and to the re-sort oracle."""
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
    want = run_windowed_path(*(torch.from_numpy(a) for a in data), t, window)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-6, atol=2e-6, equal_nan=True)
    oracle = resort_oracle(*(torch.from_numpy(a) for a in data), t, window)
    torch.testing.assert_close(got.cpu(), oracle, rtol=2e-6, atol=2e-6, equal_nan=True)
