"""The grouped rank kernel (``ops/cuda/rank_kernel.py``) on an NVIDIA GPU.

On the kernel's cases (``chip_smoke.rank_cases``) the public
``ops/segment.py:grouped_rank`` on a CUDA tensor equals its plain twin,
``grouped_rank_reference``, on the same tensor by bit pattern (any NaN equal
to any NaN), in float32 and float64; it launches the kernel exactly once a
call where the groups fit the kernel's plans and not at all past them.  The
public QDM adjust ranks sim with one launch.

Every test here needs a card (and ``nvcc``) and skips without one.  The file
imports no JAX; where JAX is absent, bypass ``tests/conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rank_kernel.py -m cuda -q
"""

import pytest
import torch

from chip_smoke import RANK_CASES, example_problem, rank_cases, run_main_path
from xsdba_tpu_torch.ops import segment
from xsdba_tpu_torch.ops.cuda import rank_kernel
from xsdba_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bits(a):
    return a.view(torch.int64 if a.dtype == torch.float64 else torch.int32)


def _same_bits(got, want):
    """Values differing by bit pattern, any NaN equal to any NaN."""
    both_nan = torch.isnan(got) & torch.isnan(want)
    return int(((_bits(got) != _bits(want)) & ~both_nan).sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("label", RANK_CASES)
def test_kernel_equals_twin_by_bit_pattern(cuda, label, dtype):
    for name, (x, gather, group_idx, slot, pct) in rank_cases(dtype, device=cuda, only=label).items():
        idx = [torch.as_tensor(a, device=cuda) for a in (gather, group_idx, slot)]
        served = rank_kernel.fits("cuda", dtype, gather.shape[-1])
        before = profiling.counters()["launch.grouped_rank"]
        got = segment.grouped_rank(x, *idx, pct=pct)
        torch.cuda.synchronize()
        assert profiling.counters()["launch.grouped_rank"] - before == int(served), name
        want = segment.grouped_rank_reference(x, *idx, pct=pct)
        assert got.shape == want.shape and got.dtype == want.dtype == dtype
        assert _same_bits(got, want) == 0, f"{name}: kernel and twin disagree"


def test_each_call_is_one_launch(cuda):
    x, gather, group_idx, slot, pct = rank_cases(torch.float32, device=cuda, only="monthly noleap 150 yr")["monthly noleap 150 yr"]
    idx = [torch.as_tensor(a, device=cuda) for a in (gather, group_idx, slot)]
    before = rank_kernel.launches
    for n in range(1, 4):
        segment.grouped_rank(x, *idx, pct=pct)
        assert rank_kernel.launches - before == n
    # numpy indexes are uploaded by the wrapper; the launch is the same
    segment.grouped_rank(x, gather, group_idx, slot, pct=pct)
    assert rank_kernel.launches - before == 4


def test_wrapper_raises_past_its_plans(cuda):
    x, gather, group_idx, slot, pct = rank_cases(torch.float32, device=cuda, only="time over 35 yr (past the plans: the twin)")[
        "time over 35 yr (past the plans: the twin)"]
    with pytest.raises(ValueError, match="rank kernel"):
        rank_kernel.grouped_rank(x, gather, group_idx, slot, pct)
    x, gather, group_idx, slot, pct = rank_cases(torch.float32, device=cuda, only="an all-NaN group")["an all-NaN group"]
    with pytest.raises(ValueError, match="rank kernel"):
        rank_kernel.grouped_rank(x.half(), gather, group_idx, slot, pct)
    with pytest.raises(ValueError, match="group_idx"):
        rank_kernel.grouped_rank(x, gather, group_idx[:-1], slot, pct)


def test_public_qdm_ranks_sim_in_one_launch(cuda):
    t, data = example_problem(16, 4)
    before = profiling.counters()["launch.grouped_rank"]
    got = run_main_path(*(torch.from_numpy(a).to(cuda) for a in data), t)
    torch.cuda.synchronize()
    assert profiling.counters()["launch.grouped_rank"] - before == 1 and got.is_cuda
    want = run_main_path(*(torch.from_numpy(a) for a in data), t)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-6, atol=2e-6)
