"""The merge engine's kernels (``xsdba_tpu_torch/ops/merge.py``) against the
JAX package's Pallas kernels, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain twin, so these tests
hold the twins to the Pallas kernels run in interpret mode: the row sort
(K3), the level build and window fold composed (K5 + K6, against the shared
fold) and the per-group merge (K4).  Rows are compared with ``==`` (so
-0.0 equals +0.0: the TPU networks may place such ties either way) on the
common prefix, with +inf required past it; the TPU kernels store a wider
row than the port.  The CUDA kernels themselves are held to the same twins
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from xsdba_tpu.ops.pallas import merge_kernel as jmk
from xsdba_tpu_torch.ops import merge as M

B, DP, M_ROW, G, YMAX = 4, 64, 16, 12, 11


def _slab(seed, sort=False):
    """[B, Dp, m] f32 rows with +inf past YMAX values, exact ties and
    signed zeros; sorted with alternating directions when ``sort``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, DP, M_ROW)).astype(np.float32)
    x[:, :, YMAX:] = np.inf
    x[0, :5, :4] = 0.0
    x[0, 5:9, :4] = -0.0
    x[1, :, :6] = np.round(x[1, :, :6])
    x = np.ascontiguousarray(x[..., np.random.default_rng(seed + 1).permutation(M_ROW)])
    if sort:
        x.sort(axis=-1)
        x = np.array(jmk.alternate_row_directions(jnp.asarray(x)))
    return x


def _same_rows(got, want):
    w = min(got.shape[-1], want.shape[-1])
    np.testing.assert_array_equal(got[..., :w] == want[..., :w], True)
    assert np.all(got[..., w:] == np.inf) and np.all(want[..., w:] == np.inf)


def test_row_sort_matches_pallas_interpret():
    x = _slab(0)
    want = np.asarray(jmk.sort_rows_alternating(jnp.asarray(x), interpret=True))
    got = M.sort_rows_alternating(torch.as_tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    assert (got.numpy() == want).all()
    g = got.numpy()
    assert (g[:, 0::2, 1:] >= g[:, 0::2, :-1]).all() and (g[:, 1::2, 1:] <= g[:, 1::2, :-1]).all()


@pytest.mark.parametrize("window", [9, 13, 16, 21, 24, 31])
def test_level_build_and_fold_match_shared_fold(window):
    """K5 + K6 twins composed, against the fused shared fold; window 24
    has the non-power-of-two bootstrap classes of the TPU kernel."""
    s = _slab(100 + window, sort=True)
    want = np.asarray(jmk.merged_window_rows_shared(jnp.asarray(s), window, G, interpret=True, ymax=YMAX, fuse_classes=True))
    st = torch.as_tensor(s)
    levels = M.build_levels(st, M.n_levels(window))
    assert tuple(levels.shape) == (B, M.n_levels(window), DP, M_ROW)
    got = M.fold_windows(st, levels, window, G, ymax=YMAX)
    assert tuple(got.shape) == (B, G, window * YMAX)
    _same_rows(got.numpy(), want)


@pytest.mark.parametrize("window", [5, 7])
def test_per_group_merge_matches_pallas_interpret(window):
    """K4's twin against the per-group Pallas merge cascade."""
    s = _slab(200 + window, sort=True)
    want = np.asarray(jmk.merged_window_rows(jnp.asarray(s), window, G, interpret=True))
    got = M.merged_window_rows(torch.as_tensor(s), window, G, ymax=YMAX)
    _same_rows(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("window", [3, 9, 31])
def test_fold_twin_equals_window_sort(dtype, window):
    """The fold's twin reads the levels; the per-group merge's twin sorts
    the window rows directly.  Both must give the same rows, at any width."""
    s = torch.as_tensor(_slab(300 + window, sort=True)).to(dtype)
    L = M.n_levels(window)
    folded = M.fold_windows_reference(s, M.build_levels_reference(s, L), window, G, out_width=window * M_ROW + 5)
    direct = M.merged_window_rows_reference(s, window, G, out_width=window * M_ROW + 5)
    assert folded.dtype == dtype and torch.equal(folded == direct, torch.ones_like(folded, dtype=torch.bool))
    assert bool(torch.isinf(folded[..., -5:]).all())


@pytest.mark.parametrize("c,window,max_rows", [(0, 31, 16), (5, 31, 16), (15, 31, 16), (3, 24, 16), (7, 9, 8), (2, 5, 1)])
def test_dyadic_segments_equal_reference(c, window, max_rows):
    segs = M.dyadic_segments(c, window, max_rows)
    assert segs == jmk._dyadic_segments(c, window, max_rows)
    assert sum(r for _, r in segs) == window and all((c + d) % r == 0 for d, r in segs)


def test_level_count_and_row_directions_equal_reference():
    for window in (9, 15, 16, 17, 24, 31, 33, 61):
        classes = min(max(jmk._next_pow2(window) // 2, 8), 16)
        assert 1 << M.n_levels(window) == classes
    x = np.sort(np.random.default_rng(5).normal(size=(3, 6, 8)), axis=-1)
    np.testing.assert_array_equal(M.alternate_row_directions(torch.as_tensor(x)).numpy(), np.asarray(jmk.alternate_row_directions(jnp.asarray(x))))


@pytest.mark.parametrize("call,err", [
    (lambda s: M.sort_rows_alternating(s[:, :, :12].contiguous()), ValueError),        # m not a power of two
    (lambda s: M.sort_rows_alternating(s.to(torch.int32)), TypeError),
    (lambda s: M.build_levels(s[:, :40].contiguous(), 4), ValueError),               # Dp not a multiple of 16
    (lambda s: M.fold_windows(s, M.build_levels(s, 4), 31, 40), ValueError),          # windows past the slab
    (lambda s: M.merged_window_rows(s, 5, G, ymax=M_ROW + 1), ValueError),
    (lambda s: M.merged_window_rows(s, 70, 1, ymax=1), ValueError),                   # more rows than the slab
    (lambda s: M.sort_rows_alternating(s.to("meta")), ValueError),                    # no kernel for the device
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call(torch.as_tensor(_slab(7, sort=True)))
