"""The generator: the same seed gives the same blocks, the work does not
depend on the seed, sim runs past hist's range, and a mix's NaN masks
take their fixed share."""

import numpy as np
import pytest
import torch

from portbench import gen, spec
from portbench.reference import calendar

AR1 = spec.module("generators", "tas_ar1")


def _config():
    bench = spec.load_benchmark()
    return spec.config(bench, bench["workloads"][0])


def _days(mix):
    return {p: calendar.days(mix.get("calendar", "noleap"), mix[f"{p}_start"], mix[f"{p}_years"]) for p in ("train", "sim")}


TINY = {"sites_per_block": 3, "train_start": "1981-01-01", "train_years": 2, "sim_start": "1981-01-01", "sim_years": 2,
        "pool_blocks": 2}


def test_same_seed_same_blocks_and_sizes():
    days = _days(TINY)
    a = gen.make_pool(2**31 + 7, _config(), TINY, days, "cpu", torch.float32)
    b = gen.make_pool(2**31 + 7, _config(), TINY, days, "cpu", torch.float32)
    c = gen.make_pool(2**31 + 8, _config(), TINY, days, "cpu", torch.float32)
    for x, y, z in zip(a, b, c):
        assert list(x) == ["ref", "hist", "sim"]
        for k in x:
            assert torch.equal(x[k], y[k]) and x[k].shape == z[k].shape and not torch.equal(x[k], z[k])
    assert not torch.equal(a[0]["ref"], a[1]["ref"])  # the pool's blocks differ


def test_ar1_matches_the_recursion():
    e = torch.randn(2, 300, dtype=torch.float64)
    phi = 0.7
    want = torch.empty_like(e)
    acc = torch.zeros(2, dtype=torch.float64)
    for t in range(300):
        acc = phi * acc + np.sqrt(1 - phi * phi) * e[:, t]
        want[:, t] = acc
    assert torch.allclose(AR1.ar1(e, phi), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mix", ["full150", "cal30_sim150"])
def test_sim_runs_past_hist(mix):
    """At a mix's own lengths, every site's sim leaves hist's range at the
    top, so the lookups reach their constant extrapolation."""
    m = dict(spec.mix({"traffic": mix}), sites_per_block=4, pool_blocks=1)
    days = _days(m)
    (b,) = gen.make_pool(5, _config(), m, days, "cpu", torch.float32)
    ref, hist, s = b["ref"], b["hist"], b["sim"]
    assert ref.shape == hist.shape == (4, days["train"].n) and s.shape == (4, days["sim"].n)
    assert torch.all(s.max(dim=1).values > hist.max(dim=1).values)
    assert torch.all(torch.isfinite(s)) and 200 < float(ref.mean()) < 330


def test_nan_masks():
    mix = dict(TINY, sites_per_block=10, nan_sites=0.2, nan_values=0.1, calendar="standard", train_years=5)
    days = _days(mix)
    for seed in (1, 2**31 + 11):
        for block in gen.make_pool(seed, _config(), mix, days, "cpu", torch.float32):
            dead = [torch.isnan(x).all(dim=1) for x in block.values()]
            assert all(int(d.sum()) == 2 and torch.equal(d, dead[0]) for d in dead)   # the same 2 sites in every input
            live = block["ref"][~dead[0]]
            assert 0.05 < float(torch.isnan(live).float().mean()) < 0.15
    assert days["train"].n == 5 * 365 + 1
