"""The port on an NVIDIA GPU: the CUDA lookup kernel against its plain twin,
and the public QDM path on CUDA tensors against the port's CPU path.

Every test here needs a card (and ``nvcc`` to build the kernel) and skips
without one.  The file imports no JAX, so it also runs where JAX is absent;
there, bypass ``tests/conftest.py`` (which imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

import xsdba_tpu_torch as xp
from chip_smoke import example_problem, lookup_inputs, run_main_path
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
