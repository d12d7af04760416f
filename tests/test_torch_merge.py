"""The merge engine's kernels (``xsdba_tpu_torch/ops/merge.py``) against the
JAX package's Pallas kernels, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain twin, so these tests
hold the twins to the Pallas kernels run in interpret mode: the row sort
(K3), the level build and window fold composed (K5 + K6, against the shared
fold) and the per-group merge (K4).  Rows are compared by bit pattern on
the common prefix, with +inf required past it (the TPU kernels store a
wider row than the port): the Pallas kernels order -0.0 below +0.0 (IEEE
totalOrder), and so do the twins (ROADMAP C32); the merges are fed rows
the K3 twin sorted.  ``tests/test_torch_merge_zeros.py`` holds the whole
engine on ±0.0-heavy data.  The CUDA kernels themselves are held to the
same twins on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from xsdba_tpu.ops.pallas import merge_kernel as jmk
from xsdba_tpu_torch.ops import merge as M
import xsdba_tpu_torch as xp


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


B, DP, M_ROW, G, YMAX = 4, 64, 16, 12, 11


def _slab(seed, sort=False):
    """[B, Dp, m] f32 rows with +inf past YMAX values, exact ties and
    signed zeros; sorted with alternating directions by the row sort's twin
    when ``sort``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, DP, M_ROW)).astype(np.float32)
    x[:, :, YMAX:] = np.inf
    x[0, :5, :4] = 0.0
    x[0, 5:9, :4] = -0.0
    x[1, :, :6] = np.round(x[1, :, :6])
    x = np.ascontiguousarray(x[..., np.random.default_rng(seed + 1).permutation(M_ROW)])
    if sort:
        x = M.sort_rows_alternating_reference(torch.as_tensor(x)).numpy()
    return x


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _same_rows(got, want):
    """Equal by bit pattern on the common width (-0.0 differs from +0.0),
    +inf past it."""
    w = min(got.shape[-1], want.shape[-1])
    np.testing.assert_array_equal(_bits(got[..., :w]), _bits(want[..., :w]))
    assert np.all(got[..., w:] == np.inf) and np.all(want[..., w:] == np.inf)


def test_row_sort_matches_pallas_interpret():
    x = _slab(0)
    want = np.asarray(jmk.sort_rows_alternating(jnp.asarray(x), interpret=True))
    got = M.sort_rows_alternating(torch.as_tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _same_rows(got.numpy(), want)
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
    assert folded.dtype == dtype
    _same_rows(folded.numpy(), direct.numpy())
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


@pytest.mark.parametrize("n,elem,limit,shared", [
    (31 * 150, 4, 232448, True),      # the heavy fold, f32: both buffers in shared memory
    (31 * 150, 8, 232448, True),
    (5 * 150, 4, 232448, True),       # the window-5 merge
    (31 * 900, 8, 231600, False),     # f64, window 31, 900 values: the output row is the second buffer
    (29056, 4, 232448, True),         # exactly two buffers
    (29057, 4, 232448, False),
])
def test_fold_variant_follows_shared_memory(n, elem, limit, shared):
    assert M.fold_scratch_in_shared(n, elem, limit) is shared


@pytest.mark.parametrize("m,warp", [
    (1, True),          # one value: a lane copies it
    (16, True),         # several rows to a warp
    (256, True),        # the heavy path's slab
    (1024, True),       # 32 values a lane: 5-day windows of 150 years
    (2048, False),      # longer rows: one block a row
    (4096, False),
    (8192, False),      # the longest power-of-two f32 row within 48 KB
])
def test_row_sort_variant_follows_row_length(m, warp):
    assert M.row_sort_in_warp(m) is warp


@pytest.mark.parametrize("m,levels,elem,limit,shared", [
    (256, 4, 4, 232448, True),      # the heavy path: 2 x 16 x 256 x 4 bytes
    (256, 4, 8, 232448, True),
    (1024, 4, 4, 232448, True),     # 128 KB
    (1024, 4, 8, 231600, False),    # f64, m = 1024: 256 KB, merged in device memory
    (1024, 3, 8, 231600, True),
    (3632, 3, 4, 232448, True),     # exactly two buffers
    (3633, 3, 4, 232448, False),
    (1, 3, 4, 232448, True),
])
def test_level_build_variant_follows_shared_memory(m, levels, elem, limit, shared):
    assert M.levels_in_shared(m, levels, elem, limit) is shared
