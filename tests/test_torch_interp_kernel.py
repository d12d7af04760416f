"""The quantile-table lookup kernel's wrapper and plain twin, on the CPU.

``xsdba_tpu_torch.ops.cuda.interp_kernel.interp_table_3d`` replaces the
Pallas kernel ``interp_table_pallas_3d``.  Here, without a card, the wrapper
runs its plain twin; the twin is held to the JAX package's plain lookup
(``_interp_unrolled``) and to the Pallas kernel in interpret mode, at
rtol = atol = 2e-6 (float32; XLA's CPU FMA contraction).  The CUDA kernel
itself is held to the twin on the card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xsdba_tpu.ops.interp import _compact_nan_pairs, _interp_unrolled
from xsdba_tpu.ops.pallas.interp_kernel import interp_table_pallas_3d
from xsdba_tpu_torch.ops import interp as tinterp
from xsdba_tpu_torch.ops.cuda import interp_kernel as k
import xsdba_tpu_torch as xp


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


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
    (torch.float32, "nearest", True),
    (torch.float64, "nearest", False),
])
def test_grouped_lookup_dispatch(monkeypatch, dtype, method, expect_wrapper):
    """The partitioned grouped lookup hands linear and nearest constant-
    extrapolated f32 tables to the kernel's wrapper (reshaped to [B, Gp, Lp]
    rows, int32 counts, with the method) and keeps everything else on the
    plain path; both give the plain answer."""
    from xsdba_tpu.utils.calendar import date_range
    from xsdba_tpu.utils.grouper import Grouper

    seen = []

    def spy(v, xs, ys, nvalid, method):
        seen.append((tuple(v.shape), tuple(xs.shape), nvalid.dtype, method))
        return k.interp_table_3d(v, xs, ys, nvalid, method)

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
    assert seen == ([((6, Gp, Lp), (6, Gp, 9), torch.int32, method)] * 2 if expect_wrapper else [])
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


# ------------------------------------------------------------- K2: [R, L] rows


def _rows(seed=6, R=5, L=300, nq=13):
    """[R, L] values and raw [R, nq] tables with NaN pairs, a whole-NaN row
    and a single-node row whose value sits on its node."""
    rng = np.random.default_rng(seed)
    xq = np.sort(rng.normal(0, 2, (R, nq)), axis=-1).astype(np.float32)
    yq = rng.normal(0, 1, (R, nq)).astype(np.float32)
    xq[0, 4] = yq[1, 9] = np.nan
    xq[2] = np.nan
    xq[3, 1:] = yq[3, 1:] = np.nan
    v = rng.normal(0, 3, (R, L)).astype(np.float32)
    v[0, :3] = np.nan
    v[3, :2] = xq[3, 0]
    return v, xq, yq


def test_row_lookup_matches_reference_interp1d_table():
    """The ungrouped lookup through K2's wrapper (its twin here) equals the
    reference's compiled ``interp1d_table`` bit for bit, and its eager form
    within 2e-6 (it rounds the blend twice)."""
    from xsdba_tpu.ops.interp import interp1d_table as jinterp1d

    v, xq, yq = _rows()
    got = tinterp.interp1d_table(*_torch(v, xq, yq))
    want = jax.jit(lambda a, b, c: jinterp1d(a, b, c, "linear", "constant"))(v, xq, yq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(jinterp1d(v, xq, yq, "linear", "constant")), **TOL)
    xs, ys, nv = tinterp._compact_nan_pairs(*_torch(xq, yq))
    twin = k.interp_table_2d_reference(torch.as_tensor(v), xs, ys, nv.to(torch.int32))
    np.testing.assert_array_equal(got.numpy(), twin.numpy())


@pytest.mark.parametrize("vshape,qshape,dtype,method,extrap,expect", [
    ((2, 3, 50), (2, 3, 8), torch.float32, "linear", "constant", (6, 50)),
    ((4, 50), (8,), torch.float32, "linear", "constant", (4, 50)),
    ((50,), (3, 8), torch.float32, "linear", "constant", (3, 50)),
    ((4, 50), (4, 8), torch.float64, "linear", "constant", None),
    ((4, 50), (4, 8), torch.float32, "nearest", "constant", (4, 50)),
    ((2, 3, 50), (8,), torch.float32, "nearest", "constant", (6, 50)),
    ((4, 50), (4, 8), torch.float64, "nearest", "constant", None),
    ((4, 50), (4, 8), torch.float32, "nearest", "nan", None),
    ((4, 50), (4, 8), torch.float32, "linear", "nan", None),
])
def test_row_lookup_dispatch(monkeypatch, vshape, qshape, dtype, method, extrap, expect):
    """``interp1d_table`` hands linear and nearest constant-extrapolated f32
    tables to K2's wrapper as [R, L] rows (the table broadcast to v's
    leading dims, int32 counts, with the method) and keeps everything else
    on the plain path; both give the plain answer."""
    seen = []

    def spy(v, xs, ys, nvalid, how):
        assert how == method
        seen.append((tuple(v.shape), tuple(xs.shape), tuple(nvalid.shape), nvalid.dtype))
        return k.interp_table_2d(v, xs, ys, nvalid, how)

    monkeypatch.setattr(tinterp, "interp_table_2d", spy)
    rng = np.random.default_rng(7)
    xq = torch.as_tensor(np.sort(rng.normal(0, 1, qshape), axis=-1), dtype=dtype)
    yq = torch.as_tensor(rng.normal(0, 1, qshape), dtype=dtype)
    v = torch.as_tensor(rng.normal(0, 1.5, vshape), dtype=dtype)
    got = tinterp.interp1d_table(v, xq, yq, method, extrap)
    assert seen == ([(expect, (expect[0], qshape[-1]), (expect[0],), torch.int32)] if expect else [])
    xs, ys, nv = tinterp._compact_nan_pairs(xq, yq)
    want = tinterp._interp_unrolled(v, xs, ys, nv, method, extrap)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_row_wrapper_on_cpu_runs_twin_and_checks_shapes():
    v, xq, yq = _rows(seed=8)
    xs, ys, nv = tinterp._compact_nan_pairs(*_torch(xq, yq))
    args = (torch.as_tensor(v), xs, ys, nv.to(torch.int32))
    before = k.launches_2d
    got = k.interp_table_2d(*args)
    assert k.launches_2d == before
    torch.testing.assert_close(got, k.interp_table_2d_reference(*args), rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError):
        k.interp_table_2d(args[0][None], *args[1:])
    with pytest.raises(ValueError):
        k.interp_table_2d(args[0], xs[:2], ys[:2], args[3])
    with pytest.raises(TypeError):
        k.interp_table_2d(args[0].double(), *args[1:])


# ------------------------------------------------- the bracketed entry


def _month_brackets(years=2):
    from xsdba_tpu.utils.calendar import date_range
    from xsdba_tpu.utils.grouper import Grouper

    gi = Grouper("time.month").indexes(date_range("2001-01-01", periods=365 * years, freq="D", calendar="noleap"))
    return gi.bracket_partitions("linear")


def _bracket_problem(seed=9, B=3, nq=11, single_node=True):
    """Monthly brackets over two noleap years, raw [B, 12, nq] tables (an
    unfitted group; optionally a single-node group) and [B, T] values."""
    b = _month_brackets()
    rng = np.random.default_rng(seed)
    xq = np.sort(rng.normal(10, 3, (B, 12, nq)), axis=-1).astype(np.float32)
    yq = rng.normal(0, 1, (B, 12, nq)).astype(np.float32)
    xq[1, 4] = yq[1, 4] = np.nan
    if single_node:
        xq[2, 7, 1:] = yq[2, 7, 1:] = np.nan
    v = rng.normal(10, 4, (B, len(b["g0"]))).astype(np.float32)
    v[0, :5] = np.nan
    v[2, 200:230:3] = xq[2, 7, 0]
    return b, v, xq, yq


def _padded(xq, yq):
    """The compacted, cyclically padded tables the bracketed entry takes."""
    xs, ys, nv = tinterp._pad_cyclic_tables(*_torch(xq, yq))
    return xs.contiguous(), ys.contiguous(), nv.to(torch.int32).contiguous()


def _steps(b):
    return torch.as_tensor(b["g0"], dtype=torch.int32), torch.as_tensor(b["g1"], dtype=torch.int32), torch.as_tensor(b["w"], dtype=torch.float32)


def test_bracketed_twin_equals_jitted_reference_grouped_lookup():
    """``interp_bracketed_reference`` against the reference's compiled
    ``interp_grouped_partitioned`` (XLA fuses the interpolation and the
    bracket blend): bit for bit."""
    from xsdba_tpu.ops.interp import interp_grouped_partitioned as jgrouped

    b, v, xq, yq = _bracket_problem()
    parts = [b[n] for n in ("part0", "g0", "slot0", "part1", "g1", "slot1", "w")]
    want = jax.jit(lambda a, x, y: jgrouped(a, x, y, *parts, "linear", "constant"))(v, xq, yq)
    got = k.interp_bracketed_reference(torch.as_tensor(v), *_padded(xq, yq), *_steps(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bracketed_twin_matches_pallas_kernel_through_the_partition_layout():
    """The TPU's route: the values gathered into bracket partitions, the
    Pallas kernel (interpret mode) on each, gathered back and blended.  The
    blend here is numpy's, rounded twice: rtol = atol = 2e-6."""
    b, v, xq, yq = _bracket_problem(seed=10, single_node=False)  # the Pallas body's single-node fault: ROADMAP C7
    xs, ys, nv = _padded(xq, yq)
    T = v.shape[-1]

    def side(part, grp, slot):
        vals = np.where(part >= 0, v[:, np.clip(part, 0, T - 1)], np.nan).astype(np.float32)
        out = interp_table_pallas_3d(jnp.asarray(vals), jnp.asarray(xs.numpy()), jnp.asarray(ys.numpy()), jnp.asarray(nv.numpy()), interpret=True)
        return np.asarray(out)[:, grp, slot]

    w = b["w"].astype(np.float32)
    want = (1 - w) * side(b["part0"], b["g0"], b["slot0"]) + w * side(b["part1"], b["g1"], b["slot1"])
    got = k.interp_bracketed_reference(torch.as_tensor(v), xs, ys, nv, *_steps(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_partition_route_equals_bracketed_twin_on_cpu():
    """On a CPU tensor ``interp_grouped_partitioned`` runs the partition
    route (two lookups through K1's twin, then the fused blend), and the
    bracketed wrapper its twin: the same bits, no launch counted."""
    b, v, xq, yq = _bracket_problem(seed=11)
    parts = [b[n] for n in ("part0", "g0", "slot0", "part1", "g1", "slot1", "w")]
    want = tinterp.interp_grouped_partitioned(*_torch(v, xq, yq), *parts, "linear", "constant")
    before = k.launches_bracketed
    got = k.interp_bracketed(torch.as_tensor(v), *_padded(xq, yq), *_steps(b))
    assert k.launches_bracketed == before
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_bracketed_twin_gives_nan_for_a_group_without_a_table():
    b, v, xq, yq = _bracket_problem(seed=12)
    g0, g1, w = _steps(b)
    g0 = g0.clone()
    g0[3], g0[4] = 14, -1
    got = k.interp_bracketed_reference(torch.as_tensor(v), *_padded(xq, yq), g0, g1, w)
    assert torch.isnan(got[:, 3:5]).all() and not torch.isnan(got[1:, 5:40]).any()


@pytest.mark.parametrize("device,dtype,nq,gp,blended,method,extrap,route", [
    ("cuda", torch.float32, 50, 14, True, "linear", "constant", "bracketed"),    # monthly QDM/EQM on the card
    ("cuda", torch.float32, 64, 6, True, "linear", "constant", "bracketed"),     # seasonal, the widest table
    ("cuda", torch.float32, 50, 367, False, "linear", "constant", "partition"),  # dayofyear: collapsed brackets
    ("cuda", torch.float32, 50, 367, True, "linear", "constant", "partition"),   # 367 tables do not fit shared memory
    ("cuda", torch.float32, 50, 46, True, "linear", "constant", "bracketed"),    # the most tables that fit
    ("cuda", torch.float32, 50, 47, True, "linear", "constant", "partition"),
    ("cpu", torch.float32, 50, 14, True, "linear", "constant", "partition"),     # K1's twin on partition rows
    ("cuda", torch.float64, 50, 14, True, "linear", "constant", "plain"),
    ("cuda", torch.float32, 65, 14, True, "linear", "constant", "plain"),
    ("cuda", torch.float32, 50, 14, False, "nearest", "constant", "partition"),  # nearest: collapsed brackets, K1
    ("cuda", torch.float32, 50, 14, True, "nearest", "constant", "partition"),   # the bracketed entry is linear only
    ("cpu", torch.float32, 20, 367, False, "nearest", "constant", "partition"),
    ("cuda", torch.float64, 50, 14, False, "nearest", "constant", "plain"),
    ("cuda", torch.float32, 50, 14, False, "nearest", "nan", "plain"),
    ("cuda", torch.float32, 50, 14, False, "cubic", "constant", "plain"),
    ("cuda", torch.float32, 50, 14, True, "linear", "nan", "plain"),
    ("meta", torch.float32, 50, 14, True, "linear", "constant", "plain"),
])
def test_lookup_route_is_a_function_of_shape_dtype_and_device(device, dtype, nq, gp, blended, method, extrap, route):
    assert tinterp.lookup_route(device, dtype, nq, gp, blended, method, extrap) == route


def test_device_brackets_keep_the_kernels_steps():
    """Blended brackets carry g0, g1 as int32 and w as float32, ready for the
    bracketed kernel; collapsed brackets (dayofyear) carry none."""
    from xsdba_tpu_torch.models._wrap import device_brackets

    t = xp.date_range("2000-01-01", periods=730, freq="D", calendar="noleap")
    br = device_brackets(xp.Grouper("time.month").indexes(t), "linear")
    g0, g1, w = br.steps
    assert (g0.dtype, g1.dtype, w.dtype) == (torch.int32, torch.int32, torch.float32)
    assert all(a.is_contiguous() and a.shape == (730,) for a in br.steps)
    assert torch.equal(g0.long(), br.g0) and torch.equal(g1.long(), br.g1) and torch.equal(w, br.w.float())
    assert len(tuple(br)) == 7
    assert device_brackets(xp.Grouper("time.dayofyear").indexes(t), "linear").steps is None


def test_bracketed_shared_memory_budget():
    """Per table, whatever its width: 65 (x, y) pairs, 129 probe nodes, four
    constants and the count."""
    assert k.bracketed_smem_bytes(1) == 8 * 65 + 4 * 129 + 16 + 4 == 1056
    assert k.bracketed_smem_bytes(14) == 14784
    assert k.bracketed_fits(46, 50) and not k.bracketed_fits(47, 50)
    assert k.bracketed_fits(46, 64) and k.bracketed_fits(46, 1) and not k.bracketed_fits(47, 1)
    assert not k.bracketed_fits(14, 65) and not k.bracketed_fits(0, 50) and not k.bracketed_fits(14, 0)


def _bad_bracketed(case):
    b, v, xq, yq = _bracket_problem(seed=13)
    xs, ys, nv = _padded(xq, yq)
    g0, g1, w = _steps(b)
    v = torch.as_tensor(v)
    many = torch.zeros((3, 47, 50))
    return {
        "v float64": ((v.double(), xs, ys, nv, g0, g1, w), TypeError),
        "g0 int64": ((v, xs, ys, nv, g0.long(), g1, w), TypeError),
        "w float64": ((v, xs, ys, nv, g0, g1, w.double()), TypeError),
        "v not 2-d": ((v[None], xs, ys, nv, g0, g1, w), ValueError),
        "tables of other sites": ((v, xs[:2], ys[:2], nv[:2], g0, g1, w), ValueError),
        "nvalid shape": ((v, xs, ys, nv[:, :3], g0, g1, w), ValueError),
        "brackets of another length": ((v, xs, ys, nv, g0[:-1], g1[:-1], w[:-1]), ValueError),
        "tables over the budget": ((v, many, many, torch.zeros((3, 47), dtype=torch.int32), g0, g1, w), ValueError),
        "not contiguous": ((v.T.contiguous().T, xs, ys, nv, g0, g1, w), ValueError),
    }[case]


@pytest.mark.parametrize("case", [
    "v float64", "g0 int64", "w float64", "v not 2-d", "tables of other sites", "nvalid shape",
    "brackets of another length", "tables over the budget", "not contiguous",
])
def test_bracketed_wrapper_rejects_what_the_kernel_does_not_take(case):
    args, err = _bad_bracketed(case)
    with pytest.raises(err):
        k.interp_bracketed(*args)


def test_chip_smoke_lookup_inputs_hold_the_binary_search_edges():
    """Tied nodes, two-node tables, +-inf values and values exactly on nodes
    are in ``chip_smoke.py``'s recipe, and on them the twin agrees with the
    reference's plain lookup bit for bit under ``jit``."""
    from chip_smoke import bracket_inputs, lookup_inputs

    v, xs, ys, nv = lookup_inputs(4, 15, 90, 13, seed=14, extra=True)
    assert (nv == 2).any() and bool(((xs[..., 1:] == xs[..., :-1]) & torch.isfinite(xs[..., 1:])).any())
    assert torch.isposinf(v).any() and torch.isneginf(v).any()
    assert bool((v[..., None] == xs[..., None, :]).any(-1).float().mean() > 0.05)
    got = k.interp_table_3d(v, xs, ys, nv)
    want = jax.jit(lambda *a: _interp_unrolled(*a, "linear", "constant"))(*(jnp.asarray(a.numpy()) for a in (v, xs, ys, nv)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    b = _month_brackets(1)
    args = bracket_inputs(2, 14, 9, b["g0"], b["g1"], b["w"], seed=15, extra=True)
    assert tuple(args[0].shape) == (2, 365) and args[4].dtype == torch.int32 and args[6].dtype == torch.float32
    assert torch.isfinite(k.interp_bracketed(*args)).any()


# ------------------------------------------------------- the nearest method


def _nearest_tables():
    """Tables where nearest has to decide, in sixteenths so that the float32
    distances are exact: values half way between two nodes (a tie takes the
    lower node), on nodes, at and beyond the ends (rank-like values: exactly
    0 and the largest node), +-inf, tied nodes, and tables of two nodes and
    one."""
    xs = np.full((6, 5), np.inf, np.float32)
    ys = np.full((6, 5), np.nan, np.float32)
    xs[0], ys[0] = np.array([1, 3, 5, 7, 9]) / 16, [1, 2, 3, 4, 5]
    xs[1], ys[1] = np.array([1, 3, 3, 3, 9]) / 16, [1, 2, 3, 4, 5]       # tied nodes
    xs[2, :2], ys[2, :2] = np.array([4, 12]) / 16, [-1, 1]                # two nodes
    xs[3, :1], ys[3, :1] = [0.5], [7]                                     # one node
    xs[4], ys[4] = np.array([0, 4, 8, 12, 16]) / 16, [5, 4, 3, 2, 1]     # nodes at the ranks' ends
    nv = np.array([5, 5, 2, 1, 5, 0], np.int32)                          # row 5: no node
    v = np.tile(np.array([0, 1, 2, 3, 4, 5, 6, 12, 8, 9, 16, -np.inf, np.inf, np.nan, 4, 2], np.float32) / 16, (6, 1))
    return v, xs, ys, nv


def test_nearest_twin_on_ties_ends_and_small_tables():
    v, xs, ys, nv = _nearest_tables()
    got = k.interp_table_2d(*_torch(v, xs, ys, nv), "nearest").numpy()
    # v * 16:        0  1  2  3  4  5  6 12  8  9 16 -inf inf nan 4  2
    np.testing.assert_array_equal(got[0], [1, 1, 1, 2, 2, 3, 3, 5, 4, 5, 5, 1, 5, np.nan, 2, 1])
    np.testing.assert_array_equal(got[2], [-1, -1, -1, -1, -1, -1, -1, 1, -1, 1, 1, -1, 1, np.nan, -1, -1])
    np.testing.assert_array_equal(got[3], [7] * 13 + [np.nan, 7, 7])
    np.testing.assert_array_equal(got[4], [5, 5, 5, 4, 4, 4, 4, 2, 3, 3, 1, 5, 1, np.nan, 4, 5])
    assert np.isnan(got[5]).all()
    # the reference's plain lookup and its compiled interp1d_table, bit for bit
    vj, xj, yj, nj = (jnp.asarray(a) for a in (v, xs, ys, nv))
    np.testing.assert_array_equal(got, np.asarray(_interp_unrolled(vj, xj, yj, nj, "nearest", "constant")))
    np.testing.assert_array_equal(got, k.interp_table_3d(*_torch(v[None], xs[None], ys[None], nv[None]), "nearest").numpy()[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_nearest_twins_match_reference(seed):
    """K1's and K2's twins under ``nearest`` equal the port's and the
    reference's ``_interp_unrolled`` and the reference's compiled
    ``interp1d_table(..., "nearest")`` under ==, edge cases included."""
    from xsdba_tpu.ops.interp import interp1d_table as jinterp1d

    v, xs, ys, nv, _ = _inputs(seed=seed)
    args = _torch(v, xs, ys, nv)
    got = k.interp_table_3d(*args, "nearest")
    torch.testing.assert_close(got, tinterp._interp_unrolled(*args, "nearest", "constant"), rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got, k.interp_table_3d_reference(*args, "nearest"), rtol=0, atol=0, equal_nan=True)
    want = _interp_unrolled(jnp.asarray(v), jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(nv), "nearest", "constant")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = [a.reshape((-1,) + a.shape[2:]) for a in args]
    got2 = k.interp_table_2d(*rows, "nearest")
    torch.testing.assert_close(got2.reshape(got.shape), got, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got2, k.interp_table_2d_reference(*rows, "nearest"), rtol=0, atol=0, equal_nan=True)
    assert (got.numpy() != k.interp_table_3d(*args).numpy())[~np.isnan(got.numpy())].any()      # not the linear answer
    # through the public lookup on uncompacted tables
    v2, xq, yq = _rows(seed=seed + 20)
    want2 = jax.jit(lambda a, b, c: jinterp1d(a, b, c, "nearest", "constant"))(v2, xq, yq)
    np.testing.assert_array_equal(tinterp.interp1d_table(*_torch(v2, xq, yq), "nearest").numpy(), np.asarray(want2))


def test_chip_smoke_rank_inputs_reach_the_ends():
    """``chip_smoke.py``'s rank-like lookup inputs (the multivariate path's:
    ranks in [0, 1] against the quantile nodes) hold exact zeros, the top
    rank and node-boundary ties, and the twin agrees with the reference."""
    from chip_smoke import rank_lookup_inputs

    v, xs, ys, nv = rank_lookup_inputs(6, 90, 20, seed=3)
    assert v.dtype == torch.float32 and tuple(xs.shape) == (6, 20) and nv.dtype == torch.int32
    finite = v[~torch.isnan(v)]
    assert torch.isnan(v).any() and (v == 0).any() and (v == 1).any() and float(finite.min()) == 0 and float(finite.max()) == 1
    mid = (xs[:, :-1] + xs[:, 1:]) / 2
    assert (v[:, :, None] == mid[:, None, :]).any()
    got = k.interp_table_2d(v, xs, ys, nv, "nearest")
    want = _interp_unrolled(*(jnp.asarray(a.numpy()) for a in (v, xs, ys, nv)), "nearest", "constant")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_rejects_an_unknown_method():
    args = _torch(*_inputs(seed=3)[:4])
    with pytest.raises(ValueError, match="methods"):
        k.interp_table_3d(*args, "cubic")
    with pytest.raises(ValueError, match="methods"):
        k.interp_table_2d_reference(*(a.reshape((-1,) + a.shape[2:]) for a in args), "cubic")
    assert k.METHODS == {"linear": 0, "nearest": 1}


# ------------------------------------------------------------- C31: +inf holes


def _holey(B=4, Gp=14, nq=50, Lp=300, seed=15):
    """``chip_smoke.holey_tables``' draws (ascending f32 nodes, factors NaN on
    a leading run of up to a third of the nodes, on 10 % of the others and
    on 2 % of the rows), laid out by the JAX package's
    ``_compact_sorted_tables`` as its grouped adjust lays trained tables
    out (+inf holes where the factor is NaN: ROADMAP C31), and values with
    the search's edges: on nodes and holes, +-inf, NaN, below and above.
    Returns numpy (v, xs, ys, nvalid int32)."""
    from xsdba_tpu.ops.interp import _compact_sorted_tables

    rng = np.random.default_rng(seed)
    xq = np.sort(rng.normal(0, 1, (B, Gp, nq)), axis=-1).astype(np.float32)
    yq = rng.normal(0, 1, (B, Gp, nq)).astype(np.float32)
    lead = rng.integers(0, nq // 3 + 1, (B, Gp))
    yq[np.arange(nq) < lead[..., None]] = np.nan
    yq[rng.random((B, Gp, nq)) < 0.1] = np.nan
    yq[rng.random((B, Gp)) < 0.02] = np.nan
    xs, ys, nv = (np.asarray(a) for a in _compact_sorted_tables(jnp.asarray(xq), jnp.asarray(yq)))
    v = rng.normal(0, 3, (B, Gp, Lp)).astype(np.float32)
    v[..., 3::11] = np.take_along_axis(xs, rng.integers(0, nq, v[..., 3::11].shape), axis=-1)
    special = rng.random(v.shape)
    v[special < 0.01] = np.nan
    v[(special >= 0.01) & (special < 0.015)] = np.inf
    v[(special >= 0.015) & (special < 0.02)] = -np.inf
    return v, xs, ys, nv.astype(np.int32)


def _same_bits(a, b):
    return bool(((a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))).all())


@pytest.mark.parametrize("form", ["3d", "2d"])
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_twins_equal_reference_on_tables_with_inf_holes(method, form):
    """ROADMAP C31: on quantile-trained tables with NaN factors inside (the
    grouped adjust's fast-path layout, the JAX package's own), the twins of
    K1 and K2 count nodes by value and take the segment by position, as the
    reference's compiled lookup does: its bits (any NaN equal to any NaN).
    The port's layout of the same tables is the reference's."""
    v, xs, ys, nv = _holey()
    before = np.isinf(xs) & ~np.isinf(np.roll(xs, -1, axis=-1)) & (np.arange(xs.shape[-1]) < xs.shape[-1] - 1)
    assert before.any(), "no +inf hole before a finite node"
    ref = jax.jit(_interp_unrolled, static_argnums=(4, 5))
    want = np.asarray(ref(*(jnp.asarray(a) for a in (v, xs, ys, nv)), method, "constant"))
    args = _torch(v, xs, ys, nv)
    if form == "3d":
        got = k.interp_table_3d(*args, method).numpy()
    else:
        got = k.interp_table_2d(*(a.reshape((-1,) + a.shape[2:]) for a in args), method).numpy().reshape(v.shape)
    assert _same_bits(got, want)
    # the port lays the trained tables out as the reference does
    rng = np.random.default_rng(15)
    xq = np.sort(rng.normal(0, 1, xs.shape), axis=-1).astype(np.float32)
    yq = np.where(np.isnan(ys), np.nan, xq)
    pxs, pys, pnv = tinterp._compact_sorted_tables(torch.from_numpy(xq), torch.from_numpy(yq))
    from xsdba_tpu.ops.interp import _compact_sorted_tables

    jxs, jys, jnv = (np.asarray(a) for a in _compact_sorted_tables(jnp.asarray(xq), jnp.asarray(yq)))
    assert _same_bits(pxs.numpy(), jxs) and _same_bits(pys.numpy(), jys) and (pnv.numpy() == jnv).all()


@pytest.mark.parametrize("form", ["3d", "2d"])
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_twins_equal_reference_on_shuffled_tables(method, form):
    """Tables whose (x, y) pairs are shuffled within each row (nodes in no
    order, the case K1 ranks by comparisons): the twins of K1 and K2 equal
    the reference's compiled lookup bit for bit (any NaN equal to any NaN)."""
    v, xs, ys, nv = _holey(seed=16)
    order = np.argsort(np.random.default_rng(17).random(xs.shape), axis=-1)
    xs, ys = np.take_along_axis(xs, order, -1), np.take_along_axis(ys, order, -1)
    ref = jax.jit(_interp_unrolled, static_argnums=(4, 5))
    want = np.asarray(ref(*(jnp.asarray(a) for a in (v, xs, ys, nv)), method, "constant"))
    args = _torch(v, xs, ys, nv)
    if form == "3d":
        got = k.interp_table_3d(*args, method).numpy()
    else:
        got = k.interp_table_2d(*(a.reshape((-1,) + a.shape[2:]) for a in args), method).numpy().reshape(v.shape)
    assert _same_bits(got, want)


@pytest.mark.parametrize("interp", ["nearest", "linear"])
def test_public_dayofyear_qdm_on_dry_days_equals_reference(monkeypatch, interp):
    """A public ``kind="*"`` dayofyear + 31 QDM adjust on dry-day precipitation
    (``chip_smoke.dry_day_problem``'s recipe: 30 % and 45 % of the days ±0.0):
    its trained factors are NaN at the low quantiles (0 / 0), so the adjust's
    tables carry +inf holes (C31) and its lookup, ``nearest`` (QDM's
    default) or ``linear``, is K1's twin; ``scen`` equals the reference's
    under ``==`` (``test_torch_qdm.py``'s tolerance for the public
    ``scen``)."""
    import xsdba_tpu as xt
    from chip_smoke import dry_day_problem

    t, data = dry_day_problem(3, 4)
    tj = xt.date_range("2000-01-01", periods=len(t), freq="D", calendar="noleap")
    pk = lambda mod, tt, a, name: mod.DataArray(a, ("site", "time"), {"time": tt}, {"units": "mm/d"}, name)  # noqa: E731
    kw = dict(kind="*", group=xp.Grouper("time.dayofyear", window=31), nquantiles=50)
    port = xp.QuantileDeltaMapping.train(pk(xp, t, data[0], "ref"), pk(xp, t, data[1], "hist"), **kw)
    kw["group"] = xt.Grouper("time.dayofyear", window=31)
    ref = xt.QuantileDeltaMapping.train(pk(xt, tj, data[0], "ref"), pk(xt, tj, data[1], "hist"), **kw)
    af = port.ds["af"].data.numpy()
    assert (np.isnan(af).any(axis=-1) & ~np.isnan(af).all(axis=-1)).any(), "no table with a NaN factor inside"
    seen = []

    def spy(*args):
        seen.append(args[-1])
        return k.interp_table_3d(*args)

    monkeypatch.setattr(tinterp, "interp_table_3d", spy)
    got = port.adjust(pk(xp, t, data[2], "sim"), interp=interp).data.numpy()
    assert seen == [interp], "the adjust's lookup did not reach K1's wrapper"
    want = np.asarray(ref.adjust(pk(xt, tj, data[2], "sim"), interp=interp).data)
    assert np.isfinite(got).any() and np.isnan(got).any()
    np.testing.assert_array_equal(got, want)
