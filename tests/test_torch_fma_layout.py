"""The host side of the fused multiply-add kernel (``ops/cuda/fma_kernel.py``):
:func:`layout` coalesces the broadcast of ``a * b + c`` and picks the
kernel that serves it.  On the CPU, with no card: every coalesced layout
addresses, at every flat output index, exactly the elements the broadcast
of the original operands addresses (enumerated with numpy), an operand
marked dense is read at the flat index itself from a 16-byte boundary, and
each layout class the port's callers pass takes the path it should."""

import numpy as np
import pytest
import torch

from xsdba_tpu_torch.ops.cuda import fma_kernel
from xsdba_tpu_torch.ops.cuda.fma_kernel import layout


def _offsets_broadcast(t, shape):
    """Element offsets (from the storage's start) of ``t`` broadcast to
    ``shape``, at every flat output index, in row-major order."""
    strides = t.expand(shape).stride() if shape else ()
    idx = np.indices(shape, dtype=np.int64).reshape(len(shape), -1) if shape else np.zeros((0, 1), np.int64)
    return t.storage_offset() + np.asarray(strides, np.int64) @ idx


def _offsets_layout(lay, k, t):
    """The same offsets as the coalesced layout addresses them."""
    idx = np.indices(lay.shape, dtype=np.int64).reshape(len(lay.shape), -1)
    return t.storage_offset() + np.asarray(lay.strides[k], np.int64) @ idx


def _check(a, b, c):
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape, c.shape))
    lay = layout(a, b, c)
    n = int(np.prod(shape, dtype=np.int64))
    assert int(np.prod(lay.shape, dtype=np.int64)) == n and all(d > 1 for d in lay.shape if len(lay.shape) > 1)
    for k, t in enumerate((a, b, c)):
        want = _offsets_broadcast(t, shape)
        np.testing.assert_array_equal(_offsets_layout(lay, k, t), want)
        if lay.dense[k]:
            assert t.data_ptr() % 16 == 0
            np.testing.assert_array_equal(want - t.storage_offset(), np.arange(n))
    assert lay.path == ("rows" if len(lay.shape) <= 2 else "strided")
    return lay


def _random_operand(rng, shape):
    """A tensor that broadcasts to ``shape``: some leading dimensions
    dropped, some set to 1, its storage permuted, padded and offset."""
    nd = len(shape)
    kept = int(rng.integers(0, nd + 1))
    own = [shape[d] if rng.random() < 0.75 else 1 for d in range(nd - kept, nd)]
    perm = rng.permutation(len(own)) if rng.random() < 0.3 else np.arange(len(own))
    stored = [own[p] for p in perm]
    padded = [s + int(rng.integers(0, 2)) for s in stored]
    size = int(np.prod(padded, dtype=np.int64))
    off = int(rng.integers(0, 4))
    base = torch.zeros(size + off + 1)
    t = base[off : off + size].reshape(padded)[tuple(slice(0, s) for s in stored)]
    t = t.permute(*np.argsort(perm).tolist()) if len(own) else t
    assert tuple(t.shape) == tuple(own)
    return t


@pytest.mark.parametrize("seed", range(48))
def test_coalesced_layout_addresses_the_same_elements(seed):
    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in rng.integers(1, 6, int(rng.integers(0, 5))))
    _check(*(_random_operand(rng, shape) for _ in range(3)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_views_offsets_and_transposes(dtype):
    base = torch.zeros(4 * 5 * 6 + 7, dtype=dtype)
    x = base[:120].reshape(4, 5, 6)
    for a, b, c in (
        (x, x[0], x[:, :1, :1]),                        # a [G, nq]-like operand and a column
        (x.transpose(0, 2), x[0, 0].reshape(6, 1, 1), x[1, 1, 1]),
        (x[:, 1:4, ::2], x[:, 1:4, 1::2], x[:, 1:4, :3]),
        (base[3:123].reshape(4, 30), base[:30], base[:4].reshape(4, 1)),
        (x.permute(1, 0, 2), x.permute(1, 0, 2), x[0].reshape(5, 1, 6)),
    ):
        _check(a, b, c)


def _rows(shape, strides, dense, lay):
    assert lay.path == "rows" and lay.shape == shape and lay.strides == strides and lay.dense == dense


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_each_layout_class_takes_its_path(dtype):
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    a, b, c = z(1_000_003), z(1_000_003), z(1_000_003)
    # contiguous and aligned: one row, every operand in vectors
    _rows((1_000_003,), ((1,), (1,), (1,)), (True, True, True), layout(a, b, c))
    # a view one element off its storage's start: read a value at a time
    _rows((1_000_000,), ((1,), (1,), (1,)), (False, True, True), layout(a[1:1_000_001], b[:1_000_000], c[:1_000_000]))
    # shorter than one vector, and n not a multiple of 4
    _rows((3,), ((1,), (1,), (1,)), (True, True, True), layout(a[:3], b[:3], c[:3]))
    # the heavy extraction's lerp: rows against a repeating [G, nq] gamma
    rows, gamma = z(512, 365, 50), z(365, 50)
    _rows((512, 18250), ((18250, 1), (0, 1), (18250, 1)), (True, False, True), layout(rows, gamma, rows))
    # a trailing broadcast (a value a row) and a leading one (a repeated row)
    _rows((250, 4000), ((4000, 1), (0, 1), (1, 0)), (True, False, False), layout(z(250, 80, 50), z(80, 50), z(250, 1, 1)))
    _rows((250, 4000), ((4000, 1), (0, 1), (0, 1)), (True, False, False), layout(z(250, 4000), z(4000), z(1, 4000)))
    # the QDM virtual index [sites, 12, 1] * [nq] + [nq]
    _rows((6144, 50), ((1, 0), (0, 1), (0, 1)), (False, False, False), layout(z(512, 12, 1), z(50), z(50)))
    # the selection lerp on slices of [rows, G, 2 nq + 1] picks
    picks = z(448, 365, 101)
    _rows((163520, 50), ((101, 1), (50, 1), (101, 1)), (False, True, False), layout(picks[..., 50:100], z(448, 365, 50), picks[..., :50]))
    # 0-dim operands, and a 0-dim output
    _rows((1000,), ((1,), (0,), (0,)), (True, False, False), layout(a[:1000], z(()), z(())))
    _rows((1,), ((0,), (0,), (0,)), (False, False, False), layout(z(()), z(()), z(())))
    # a transposed operand: three dimensions stay, the strided fallback
    t = layout(z(250, 50, 80).transpose(1, 2), z(80, 50), z(250, 1, 1))
    assert t.path == "strided" and t.shape == (250, 80, 50) and t.strides[0] == (4000, 1, 80)
    # 2^31 values (a broadcast view, nothing allocated): past the rows kernel's 32-bit index
    big = layout(z(1).expand(2**31), z(()), z(()))
    assert big.path == "strided" and big.shape == (2**31,)


def test_cpu_tensors_take_the_emulation():
    """On the CPU the wrapper is the twin and launches nothing."""
    rng = np.random.default_rng(3)
    a, b, c = (torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32)) for _ in range(3))
    before = fma_kernel.launches
    got = fma_kernel.fma(a, b[0], c[:, :1])
    assert fma_kernel.launches == before
    assert torch.equal(got, fma_kernel.fma_reference(a, b[0], c[:, :1]))
