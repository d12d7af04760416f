"""The grouped rank's route, on the CPU.

``ops/segment.py:grouped_rank`` sends a CUDA tensor whose groups fit the
hand-written kernel (``ops/cuda/rank_kernel.py:fits``) to it and every other
tensor to its plain twin, ``grouped_rank_reference``.  Here, without a card,
every case takes the twin: no kernel launch is counted, and the result is
held to the JAX package's ``grouped_rank`` on the kernel's cases
(``chip_smoke.rank_cases``: monthly and windowed groups, -1 padding at each
shared-memory plan's edge, all-NaN and single-value groups, ±0.0 ties, +inf
runs before NaN, a row past the plans), float64 within 1e-12 and float32
within rtol = atol = 2e-6.  ``tests/test_torch_rank_kernel.py`` holds the
kernel to the twin on the card.
"""

import numpy as np
import pytest
import torch

import xsdba_tpu.ops.segment as jseg
import xsdba_tpu_torch as xp
from chip_smoke import RANK_CASES, rank_cases
from xsdba_tpu_torch.ops import segment
from xsdba_tpu_torch.ops.cuda import rank_kernel
from xsdba_tpu_torch.utils import profiling

TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12), torch.float32: dict(rtol=2e-6, atol=2e-6)}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


@pytest.mark.parametrize("device,dtype,row_len,served", [
    ("cuda", torch.float32, 4650, True),                  # monthly and dayofyear + 31 over 150 yr
    ("cuda", torch.float64, 930, True),
    ("cuda", torch.float32, 1, True),
    ("cuda", torch.float32, rank_kernel.MAX_ROW, True),   # time over 30 yr: 10,950 to 10,957
    ("cuda", torch.float32, rank_kernel.MAX_ROW + 1, False),
    ("cuda", torch.float32, 54750, False),                # time over 150 yr
    ("cuda", torch.float32, 0, False),
    ("cuda", torch.float16, 4650, False),
    ("cuda", torch.bfloat16, 4650, False),
    ("cpu", torch.float32, 4650, False),
    ("cpu", torch.float64, 930, False),
])
def test_the_route_reads_device_dtype_and_row_length(device, dtype, row_len, served):
    assert rank_kernel.fits(device, dtype, row_len) is served


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("label", RANK_CASES)
def test_cpu_takes_the_twin_and_equals_the_reference(label, dtype):
    cases = rank_cases(dtype, sites=2, only=label)
    assert cases
    for name, (x, gather, group_idx, slot, pct) in cases.items():
        assert (gather[group_idx, slot] == np.arange(len(group_idx))).all(), f"{name}: a step no slot writes"
        before = profiling.counters()["launch.grouped_rank"]
        got = segment.grouped_rank(x, gather, group_idx, slot, pct=pct)
        assert profiling.counters()["launch.grouped_rank"] == before, name
        twin = segment.grouped_rank_reference(x, gather, group_idx, slot, pct=pct)
        assert torch.equal(torch.isnan(got), torch.isnan(twin)) and torch.equal(got.nan_to_num(), twin.nan_to_num()), name
        assert got.dtype == dtype and got.shape == x.shape
        want = np.asarray(jseg.grouped_rank(x.numpy(), gather, group_idx, slot, pct=pct))
        np.testing.assert_allclose(got.numpy(), want, equal_nan=True, err_msg=name, **TOL[dtype])


def test_the_wrapper_takes_the_twin_on_the_cpu():
    x, gather, group_idx, slot, pct = rank_cases(torch.float32, sites=2, only="an all-NaN group")["an all-NaN group"]
    before = rank_kernel.launches
    got = rank_kernel.grouped_rank(x, gather, group_idx, slot, pct)
    assert rank_kernel.launches == before
    assert torch.equal(got.nan_to_num(), segment.grouped_rank_reference(x, gather, group_idx, slot, pct).nan_to_num())
