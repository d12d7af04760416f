"""The quantile-table lookup kernel's wrapper and plain twin, on the CPU.

``xsdba_tpu_torch.ops.cuda.interp_kernel.interp_table_3d`` replaces the
Pallas kernel ``interp_table_pallas_3d``.  Here, without a card, the wrapper
runs its plain twin; the twin is held to the JAX package's plain lookup
(``_interp_unrolled``) and to the Pallas kernel in interpret mode, at
rtol = atol = 2e-6 (float32; XLA's CPU FMA contraction).  The CUDA kernel
itself is held to the twin on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xsdba_tpu.ops.interp import _compact_nan_pairs, _interp_unrolled
from xsdba_tpu.ops.pallas.interp_kernel import interp_table_pallas_3d
from xsdba_tpu_torch.ops import interp as tinterp
from xsdba_tpu_torch.ops.cuda import interp_kernel as k

TOL = dict(rtol=2e-6, atol=2e-6, equal_nan=True)


def _inputs(seed=0, B=3, Gp=7, Lp=96, nq=13):
    """Compacted f32 tables with the lookup's edge cases, and values.

    Returns numpy (v, xs, ys, nvalid, single_mask), where ``single_mask``
    marks values that sit exactly on the node of a single-node table whose
    pad slot carries a NaN y (the Pallas body's fault, ROADMAP C7)."""
    rng = np.random.default_rng(seed)
    xq = np.sort(rng.normal(0, 2, (B, Gp, nq)), axis=-1)
    yq = rng.normal(0, 1, (B, Gp, nq))
    xq[0, 1, 4] = np.nan                 # NaN pairs inside tables
    yq[0, 2, 9] = np.nan
    xq[1, 0, :] = yq[1, 0, :] = np.nan   # whole-NaN rows (nvalid = 0)
    yq[2, 3, :] = np.nan
    xq[1, 2, 1:] = np.nan                # single-node rows
    yq[2, 5, 1:] = np.nan
    v = rng.normal(0, 3, (B, Gp, Lp))    # values below, inside and above
    v[0, 0, :4] = np.nan                 # NaN values
    v[2, 6, 5] = np.nan
    xs, ys, nv = (np.asarray(a) for a in _compact_nan_pairs(jnp.asarray(xq, jnp.float32), jnp.asarray(yq, jnp.float32)))
    single = np.zeros(v.shape, bool)
    for b, g in ((1, 2), (2, 5)):
        assert nv[b, g] == 1
        v[b, g, :3] = [xs[b, g, 0] - 0.5, xs[b, g, 0], xs[b, g, 0] + 0.5]
        single[b, g, 1] = np.isnan(ys[b, g, 1])
    assert single.sum() == 1
    return v.astype(np.float32), xs, ys, nv.astype(np.int32), single


def _torch(*arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


def test_twin_matches_reference_plain_lookup():
    v, xs, ys, nv, _ = _inputs()
    want = np.asarray(_interp_unrolled(jnp.asarray(v), jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(nv), "linear", "constant"))
    got = k.interp_table_3d_reference(*_torch(v, xs, ys, nv))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_twin_matches_pallas_kernel_interpret():
    """Everywhere except a value exactly on a single-node table's node, where
    the Pallas body returns NaN for lack of the ``isnan(y1)`` guard that the
    plain path has (ROADMAP C7); the twin follows the plain path there."""
    v, xs, ys, nv, single = _inputs(seed=1)
    want = np.asarray(interp_table_pallas_3d(jnp.asarray(v), jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(nv), interpret=True))
    got = k.interp_table_3d_reference(*_torch(v, xs, ys, nv)).numpy()
    np.testing.assert_allclose(got[~single], want[~single], **TOL)
    assert np.isnan(want[single]).all()
    assert not np.isnan(got[single]).any()


def test_single_node_on_the_node_pinned():
    """nvalid == 1 and v == xs[0]: the table's one value, as the plain path
    gives on every backend (the Pallas body gives NaN there)."""
    xs = np.full((1, 1, 4), np.inf, np.float32)
    ys = np.full((1, 1, 4), np.nan, np.float32)
    xs[0, 0, 0], ys[0, 0, 0] = 1.0, 5.0
    v = np.array([[[0.5, 1.0, 1.5]]], np.float32)
    nv = np.ones((1, 1), np.int32)
    want = np.asarray(_interp_unrolled(jnp.asarray(v), jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(nv), "linear", "constant"))
    np.testing.assert_array_equal(want, [[[5, 5, 5]]])
    np.testing.assert_array_equal(k.interp_table_3d(*_torch(v, xs, ys, nv)).numpy(), [[[5, 5, 5]]])


def test_wrapper_on_cpu_runs_twin_and_counts_no_launch():
    v, xs, ys, nv, _ = _inputs(seed=2)
    args = _torch(v, xs, ys, nv)
    before = k.launches
    got = k.interp_table_3d(*args)
    assert k.launches == before
    assert got.dtype == torch.float32 and got.shape == v.shape
    torch.testing.assert_close(got, k.interp_table_3d_reference(*args), rtol=0, atol=0, equal_nan=True)


def _bad_inputs(case):
    v, xs, ys, nv = _torch(*_inputs(seed=3)[:4])
    wide = torch.full(xs.shape[:2] + (k.MAX_NQ + 1,), float("inf"))
    return {
        "v float64": ((v.double(), xs, ys, nv), TypeError),
        "nvalid int64": ((v, xs, ys, nv.long()), TypeError),
        "v not 3-d": ((v[0], xs, ys, nv), ValueError),
        "table rows differ": ((v, xs[:, :2], ys[:, :2], nv), ValueError),
        "xs/ys differ": ((v, xs, ys[..., :4], nv), ValueError),
        "nvalid shape": ((v, xs, ys, nv[:, :2]), ValueError),
        "nq too wide": ((v, wide, wide, nv), ValueError),
        "not contiguous": ((v.transpose(0, 1).contiguous().transpose(0, 1), xs, ys, nv), ValueError),
    }[case]


@pytest.mark.parametrize("case", [
    "v float64", "nvalid int64", "v not 3-d", "table rows differ", "xs/ys differ", "nvalid shape",
    "nq too wide", "not contiguous",
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    args, err = _bad_inputs(case)
    with pytest.raises(err):
        k.interp_table_3d(*args)


@pytest.mark.parametrize("dtype,method,expect_wrapper", [
    (torch.float32, "linear", True),
    (torch.float64, "linear", False),
    (torch.float32, "nearest", False),
])
def test_grouped_lookup_dispatch(monkeypatch, dtype, method, expect_wrapper):
    """The partitioned grouped lookup hands linear/constant f32 tables to the
    kernel's wrapper (reshaped to [B, Gp, Lp] rows, int32 counts) and keeps
    everything else on the plain path; both give the plain answer."""
    from xsdba_tpu.utils.calendar import date_range
    from xsdba_tpu.utils.grouper import Grouper

    seen = []

    def spy(v, xs, ys, nvalid):
        seen.append((tuple(v.shape), tuple(xs.shape), nvalid.dtype))
        return k.interp_table_3d(v, xs, ys, nvalid)

    monkeypatch.setattr(tinterp, "interp_table_3d", spy)
    gi = Grouper("time.month").indexes(date_range("2001-01-01", periods=365 * 2, freq="D", calendar="noleap"))
    rng = np.random.default_rng(4)
    xq = torch.as_tensor(np.sort(rng.normal(10, 3, (2, 3, 12, 9)), axis=-1), dtype=dtype)
    yq = torch.as_tensor(rng.normal(0, 1, (2, 3, 12, 9)), dtype=dtype)
    v = torch.as_tensor(rng.normal(10, 4, (2, 3, 730)), dtype=dtype)
    b = gi.bracket_partitions(method)
    parts = [b[n] for n in ("part0", "g0", "slot0", "part1", "g1", "slot1", "w")]
    got = tinterp.interp_grouped_partitioned(v, xq, yq, *parts, method, "constant", tables_compact=True)
    Gp, Lp = b["part0"].shape
    assert seen == ([((6, Gp, Lp), (6, Gp, 9), torch.int32)] * 2 if expect_wrapper else [])
    monkeypatch.setattr(tinterp, "KERNEL_MAX_NQ", 0)  # force the plain path
    want = tinterp.interp_grouped_partitioned(v, xq, yq, *parts, method, "constant", tables_compact=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_chip_smoke_inputs_cover_the_edge_cases():
    """``chip_smoke.py`` holds the kernel to this twin on the card; on its own
    input recipe (at a small shape) the twin agrees with the reference."""
    from chip_smoke import lookup_inputs

    v, xs, ys, nv = lookup_inputs(2, 5, 70, 13, seed=5)
    assert nv.dtype == torch.int32 and (nv == 0).any() and (nv == 1).any() and ((nv > 1) & (nv < 13)).any()
    assert torch.isnan(v).any() and (v < xs[..., :1]).any() and (v > xs[..., -1:]).any()
    got = k.interp_table_3d(v, xs, ys, nv)
    vj, xj, yj, nj = (jnp.asarray(a.numpy()) for a in (v, xs, ys, nv))
    np.testing.assert_allclose(got.numpy(), np.asarray(_interp_unrolled(vj, xj, yj, nj, "linear", "constant")), **TOL)
