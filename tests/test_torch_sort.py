"""The key–payload row sort's wrapper and plain twin (``ops/sort.py``), on
the CPU.

``sort_rows_with_payload`` replaces the Pallas kernel of the same name
(``xsdba_tpu/ops/pallas/sort_kernel.py``).  Here, without a card, the
wrapper runs its plain twin; the twin is held to the reference's network
through plain XLA (``use_kernel=False``) and to the Pallas kernel in
interpret mode: keys equal under ``==`` (exactly: no tolerance), the same
multiset of (key, payload) pairs (the order of equal keys is free), and the
pads (+inf, 0).  The CUDA kernel is held to the twin on the card by
``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xsdba_tpu_torch as xp
from chip_smoke import pair_sorted, sort_inputs
from xsdba_tpu.ops.pallas.sort_kernel import sort_rows_with_payload as jsort
from xsdba_tpu_torch.ops import sort


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("shape", [(3, 1000), (2, 8192)])
def test_twin_matches_reference(mode, shape):
    B, T = shape
    key, lab = sort_inputs(B, T, seed=T)
    kw = dict(use_kernel=False) if mode == "xla" else dict(interpret=True, use_kernel=True)
    want_k, want_l = (torch.from_numpy(np.array(a)) for a in jsort(jnp.asarray(key.numpy()), jnp.asarray(lab.numpy()), **kw))
    got_k, got_l = sort.sort_rows_with_payload_reference(key, lab)
    Tp = sort.padded_length(T)
    assert tuple(got_k.shape) == tuple(want_k.shape) == (B, Tp) and got_l.dtype == torch.int32
    assert bool((got_k == want_k).all())
    gk, gl = pair_sorted(got_k, got_l)
    wk, wl = pair_sorted(want_k, want_l)
    assert bool((gk == wk).all() and (gl == wl).all())
    assert bool(torch.isinf(got_k[:, T:]).all() and (got_l[:, T:] == 0).all())
    assert bool((got_k[:, :T] == torch.sort(key, dim=1).values).all())


@pytest.mark.parametrize("T,Tp", [(1, 128), (128, 128), (129, 256), (1000, 1024), (54750, 65536), (1 << 20, 1 << 20)])
def test_padded_length_is_the_reference_rule(T, Tp):
    assert sort.padded_length(T) == Tp


def test_wrapper_on_cpu_runs_twin_and_counts_no_launch():
    key, lab = sort_inputs(2, 300, seed=1)
    before = sort.launches
    got = sort.sort_rows_with_payload(key, lab)
    want = sort.sort_rows_with_payload_reference(key, lab)
    assert sort.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case,err", [
    ("f64", TypeError), ("int64 payload", TypeError), ("shape", ValueError), ("1-D", ValueError), ("too long", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, err):
    key, lab = sort_inputs(2, 64)
    if case == "f64":
        key = key.double()
    elif case == "int64 payload":
        lab = lab.long()
    elif case == "shape":
        lab = lab[:, :10]
    elif case == "1-D":
        key, lab = key[0], lab[0]
    else:
        key, lab = torch.zeros((1, (1 << 22) + 1)), torch.zeros((1, (1 << 22) + 1), dtype=torch.int32)
    with pytest.raises(err):
        sort.sort_rows_with_payload(key, lab)


def test_tile_matches_the_kernel_source():
    src = (Path(sort.__file__).resolve().parents[1] / "csrc" / "sort_kernel.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == sort.TILE == 16384


@pytest.mark.parametrize("Tp,passes", [(128, 0), (8192, 0), (16384, 0), (32768, 1), (65536, 2), (1 << 20, 6), (1 << 22, 8)])
def test_merge_passes_halve_to_one_tile(Tp, passes):
    assert sort.merge_passes(Tp) == passes
    # each pass doubles the sorted runs, from one tile (or the whole row) to Tp
    assert min(Tp, sort.TILE) << passes == Tp


@pytest.mark.parametrize("B,T,n", [(0, 300, 0), (1, 1, 1), (3, 16383, 1), (3, 16384, 1), (3, 16385, 2), (448, 54750, 3), (1, 1 << 20, 7), (1, 1 << 22, 9)])
def test_launch_count_is_one_tile_sort_and_the_passes(B, T, n):
    assert sort.launch_count(B, T) == n


def _key_classes():
    tiny = np.finfo(np.float32).tiny
    sub = np.array([tiny / 2, tiny / 1024, np.float32(1e-45)], dtype=np.float32)  # subnormals
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        [-np.inf, np.inf, 0.0, -0.0, tiny, -tiny, np.finfo(np.float32).max, -np.finfo(np.float32).max],
        sub, -sub, rng.normal(0, 1, 40), -np.exp(rng.normal(0, 10, 20)), np.exp(rng.normal(0, 10, 20)),
    ]).astype(np.float32)
    return torch.from_numpy(vals)


def test_key_bits_order_as_the_floats():
    x = _key_classes()
    bits = sort.key_bits_reference(x)
    assert bits.dtype == torch.int64 and bool(((bits >= 0) & (bits < 1 << 32)).all())
    a, b = x[:, None], x[None, :]
    ba, bb = bits[:, None], bits[None, :]
    zeros = (a == 0) & (b == 0)  # +-0.0 may tie either way
    assert bool(((a < b) == (ba < bb))[~zeros].all())
    assert bool(((a == b) == (ba == bb))[~zeros].all())
    # the image is one-to-one: ordering by it sorts the floats
    order = torch.argsort(bits)
    assert bool((x[order][1:] >= x[order][:-1]).all())
    assert int(sort.key_bits_reference(torch.tensor([-0.0]))) + 1 == int(sort.key_bits_reference(torch.tensor([0.0])))
    # +inf, the pad, lies above every finite key
    assert int(sort.key_bits_reference(torch.tensor([np.inf]))) == int(bits.max())
