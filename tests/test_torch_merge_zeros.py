"""Signs of zero through the port's merge engine against the JAX package's
Pallas merge kernels, on the CPU (ROADMAP C32, C33).

The Pallas kernels (``xsdba_tpu/ops/pallas/merge_kernel.py``, run in
interpret mode as ``tests/test_merge_quantile.py`` runs them) sort and merge
with min/max networks, which put -0.0 below +0.0: every row they give is
ordered by IEEE totalOrder.  The port's twins (``ops/merge.py``) sort by
the same order, so a quantile that falls on a run of zeros takes the
kernels' sign, and a ``kind="*"`` factor over such a quantile the kernels'
infinity.  ``==`` hides -0.0 against +0.0, so everything here is compared
by bit pattern (any NaN equal to any NaN).

The inputs are precipitation-like: gamma values with 45 % of the days
±0.0 in random order.  The reference's CPU default merges with its XLA
fallback (``merged_window_rows_xla``), which does not keep that order; the
tests hold the port to the kernels (ROADMAP C3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import xsdba_tpu as xt
import xsdba_tpu_torch as xp
from xsdba_tpu.ops import quantile as jquant
from xsdba_tpu.ops.pallas import merge_kernel as jmk
from xsdba_tpu_torch.ops import merge as M
from xsdba_tpu_torch.ops import quantile as pquant
from xsdba_tpu_torch.ops.correction import equally_spaced_nodes


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


def dry(shape, dtype, seed, frac=0.45):
    """Gamma(2, 2) values with ``frac`` of them ±0.0 (half each, at random)."""
    rng = np.random.default_rng(seed)
    x = rng.gamma(2.0, 2.0, shape).astype(dtype)
    zero = rng.random(shape) < frac
    x[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
    return x


def assert_same_bits(got, want):
    """Equal by bit pattern (any NaN equal to any NaN)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    ints = np.int32 if got.dtype == np.float32 else np.int64
    differ = (np.ascontiguousarray(got).view(ints) != np.ascontiguousarray(want).view(ints)) & ~(np.isnan(got) & np.isnan(want))
    assert not differ.any(), f"{int(differ.sum())} of {got.size} values differ by bit pattern"


def slab(B, Dp, m, ymax, dtype, seed):
    """[B, Dp, m] rows of :func:`dry` values, +inf past ``ymax``."""
    x = dry((B, Dp, m), dtype, seed)
    x[..., ymax:] = np.inf
    return x


def in_total_order(rows):
    keys = M._ordered_keys(torch.as_tensor(rows))
    return bool((keys[..., 1:] >= keys[..., :-1]).all())


# ------------------------------------------------------------ the twins


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [16, 2048])
def test_row_sort_twin_equals_pallas_by_bit_pattern(dtype, m):
    """K3's twin against ``sort_rows_alternating`` in interpret mode, rows of
    16 and of 2048 values (the card's long-row variant)."""
    x = slab(2, 4 if m > 16 else 64, m, m - 3, dtype, seed=m)
    want = np.asarray(jmk.sort_rows_alternating(jnp.asarray(x), interpret=True))
    got = M.sort_rows_alternating(torch.as_tensor(x))
    assert_same_bits(got, want)
    assert in_total_order(got[:, 0::2]) and in_total_order(torch.flip(got[:, 1::2], dims=(-1,)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("window", [3, 5, 7])
def test_per_group_merge_twin_equals_pallas_by_bit_pattern(dtype, window):
    """K4's twin against ``merged_window_rows`` in interpret mode, on rows the
    K3 twin sorted."""
    G, ymax = 12, 11
    s = M.sort_rows_alternating_reference(torch.as_tensor(slab(3, 32, 16, ymax, dtype, seed=window)))
    want = np.asarray(jmk.merged_window_rows(jnp.asarray(s.numpy()), window, G, interpret=True))
    got = M.merged_window_rows(s, window, G, ymax=ymax)
    assert_same_bits(got, want[..., : got.shape[-1]])
    assert in_total_order(got)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_level_build_and_fold_twins_equal_pallas_by_bit_pattern(dtype, window=9):
    """K5's and K6's twins composed against ``merged_window_rows_shared`` in
    interpret mode (the fused shared fold), on rows the K3 twin sorted;
    window 31 runs through them in the engine's cases below."""
    G, ymax = 12, 11
    s = M.sort_rows_alternating_reference(torch.as_tensor(slab(2, 64, 16, ymax, dtype, seed=window)))
    want = np.asarray(jmk.merged_window_rows_shared(jnp.asarray(s.numpy()), window, G, interpret=True, ymax=ymax, fuse_classes=True))
    levels = M.build_levels(s, M.n_levels(window))
    assert all(in_total_order(levels[:, k].reshape(2, -1, (2 << k) * 16)) for k in range(levels.shape[1]))
    got = M.fold_windows(s, levels, window, G, ymax=ymax)
    assert_same_bits(got, want[..., : got.shape[-1]])


def test_total_order_sort_orders_signed_zeros():
    x = torch.tensor([[0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, -0.0, 0.0, 5e-45, -5e-45]], dtype=torch.float32)
    got = M.total_order_sort(x)
    assert torch.equal(torch.signbit(got), torch.tensor([[True] * 5 + [False] * 5]))
    assert_same_bits(got, np.array([[-np.inf, -1.0, -5e-45, -0.0, -0.0, 0.0, 0.0, 5e-45, 1.0, np.inf]], dtype=np.float32))


# ------------------------------------------------------------ the engine


ENGINE_CASES = [
    # calendar, window, dtype
    ("noleap", 5, np.float32),
    ("noleap", 7, np.float32),
    ("noleap", 9, np.float32),
    ("noleap", 31, np.float32),
    ("standard", 31, np.float32),
    ("noleap", 5, np.float64),
]


@pytest.mark.parametrize("calendar,window,dtype", ENGINE_CASES)
def test_merge_engine_equals_pallas_kernels_by_bit_pattern(calendar, window, dtype):
    """``windowed_group_quantile`` on the merge engine (``selection_backend=False``)
    against the reference's with its Pallas kernels in interpret mode, on 2
    sites x 4 years: every quantile's bits, the signs of zero among them
    (before the twins sorted by totalOrder, 3,316, 3,613, 3,129 and 4,181
    of 36,500 differed at windows 5, 7, 9 and 31, and 3,886 of 36,600 on
    the standard calendar: ``scripts/count_zero_signs.py``)."""
    kw = dict(periods=365 * 4, freq="D", calendar=calendar)
    gj = xt.Grouper("time.dayofyear", window=window).indexes(xt.date_range("2001-01-01", **kw))
    gp = xp.Grouper("time.dayofyear", window=window).indexes(xp.date_range("2001-01-01", **kw))
    x = dry((2, 365 * 4), dtype, seed=window)
    q = equally_spaced_nodes(50).astype(dtype)
    want = np.asarray(jquant.windowed_group_quantile(x, gj.merge_plan, q, use_kernel=True, interpret=True))
    with xp.set_options(selection_backend=False):
        got = pquant.windowed_group_quantile(torch.as_tensor(x), gp.merge_plan, torch.as_tensor(q))
    assert (got == 0).sum() > 100, "too few quantiles on the zeros to test their sign"
    assert_same_bits(got, want)


def _through_pallas_kernels(monkeypatch):
    """The reference's merge engine on its Pallas kernels in interpret mode
    (its CPU default is the XLA fallback)."""
    for name in ("sort_rows_alternating", "merged_window_rows", "merged_window_rows_shared"):
        kernel = getattr(jmk, name)
        monkeypatch.setattr(jmk, name, lambda *a, _k=kernel, interpret=False, **k: _k(*a, interpret=True, **k))
    monkeypatch.setattr(jquant, "_merge_backend_default", lambda dtype: True)


def _train(mod, t, data, group, engine_kw):
    da = lambda a, name: mod.DataArray(a, ("site", "time"), {"time": t}, {"units": "mm/d"}, name)  # noqa: E731
    with mod.set_options(**engine_kw):
        return mod.QuantileDeltaMapping.train(da(data[0], "ref"), da(data[1], "hist"), kind="*", group=group, nquantiles=50)


def _adjust(mod, t, obj, sim):
    return obj.adjust(mod.DataArray(sim, ("site", "time"), {"time": t}, {"units": "mm/d"}, "sim"), interp="nearest").data


def _dry_problem(n_days, seed=14):
    """``chip_smoke.dry_day_problem``'s recipe at any length: ref 30 %, hist
    and sim 45 % of the days ±0.0, 3 sites, one generator."""
    rng = np.random.default_rng(seed)
    out = []
    for frac in (0.3, 0.45, 0.45):
        x = rng.gamma(2.0, 2.0, (3, n_days)).astype(np.float32)
        zero = rng.random(x.shape) < frac
        x[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
        out.append(x)
    return out


def test_standard_calendar_kind_mul_factors_equal_reference(monkeypatch):
    """ROADMAP C33: on a standard calendar the selection engine cannot serve
    dayofyear windows, so the port's default train takes the merge twins.
    The public ``kind="*"`` dayofyear + 31 QDM train (3 sites, 1461 days,
    default options in both packages) gives the reference's factors by bit
    pattern, infinities of either sign among them (958 of 54,900 differed
    before the twins sorted by totalOrder); ``scen`` under ``==`` as
    ``test_torch_qdm.py`` holds it.  ``hist_q`` is held to the reference
    run through its Pallas kernels: its default XLA fallback gives 12 of
    these 54,900 quantiles the other sign of zero (each under a NaN factor,
    0 / 0, so ``af`` agrees)."""
    kw = dict(periods=1461, freq="D", calendar="standard")
    tj, tp = xt.date_range("2000-01-01", **kw), xp.date_range("2000-01-01", **kw)
    data = _dry_problem(1461)
    group = xt.Grouper("time.dayofyear", window=31)
    port = _train(xp, tp, data, xp.Grouper("time.dayofyear", window=31), {})
    ref = _train(xt, tj, data, group, {})
    af = port.ds["af"].data
    assert bool(torch.isinf(af).any()) and bool((torch.isinf(af) & torch.signbit(af)).any())
    assert_same_bits(af, ref.ds["af"].data)
    np.testing.assert_array_equal(_adjust(xp, tp, port, data[2]).numpy(), np.asarray(_adjust(xt, tj, ref, data[2])))
    _through_pallas_kernels(monkeypatch)
    kernels = _train(xt, tj, data, group, {})
    assert_same_bits(af, kernels.ds["af"].data)
    assert_same_bits(port.ds["hist_q"].data, kernels.ds["hist_q"].data)


def test_noleap_merge_engine_kind_mul_factors_equal_reference_kernels(monkeypatch):
    """The same train on noleap at window 5 with both packages pinned to
    their merge engines (``selection_backend=False``).  The reference's CPU
    default merges with its XLA fallback, whose order of ±0.0 is not its
    kernels': 41 of these 54,750 factors (and 127 ``hist_q``) differ
    between the two (``scripts/count_zero_signs.py``).  So the
    port is held to the reference run through its Pallas kernels in
    interpret mode (1,441 of its factors differed before the twins sorted
    by totalOrder, 1,327 of them infinities of the other sign)."""
    kw = dict(periods=1460, freq="D", calendar="noleap")
    tj, tp = xt.date_range("2000-01-01", **kw), xp.date_range("2000-01-01", **kw)
    data = _dry_problem(1460)
    _through_pallas_kernels(monkeypatch)
    merge_engine = {"selection_backend": False}
    port = _train(xp, tp, data, xp.Grouper("time.dayofyear", window=5), merge_engine)
    ref = _train(xt, tj, data, xt.Grouper("time.dayofyear", window=5), merge_engine)
    assert_same_bits(port.ds["af"].data, ref.ds["af"].data)
    assert_same_bits(port.ds["hist_q"].data, ref.ds["hist_q"].data)
